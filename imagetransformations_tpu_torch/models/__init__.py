"""The classifiers (PyTorch, NCHW): the JAX package's ``models`` names.

``load_torch_state_dict`` and its aliases load a reference checkpoint's
state_dict by key (the port's parameter names are the checkpoints' own);
``from_flax`` carries parameters across from the JAX package.
"""

from imagetransformations_tpu_torch.models.resnet import (  # noqa: F401
    CifarResNet,
    resnet20,
    resnet56,
)
from imagetransformations_tpu_torch.models.simple_cnn import SimpleCNN  # noqa: F401
from imagetransformations_tpu_torch.models.bayesian import BayesianCNN  # noqa: F401
from imagetransformations_tpu_torch.models.imagenet import (  # noqa: F401
    ResNet50,
    VGG19BN,
    ResNet18,
    normalize_imagenet,
)
from imagetransformations_tpu_torch.models.convert import (  # noqa: F401
    from_flax,
    load_torch_state_dict,
)

#: the JAX package's per-architecture importers; here one load by key
load_resnet_torch_state_dict = load_torch_state_dict
load_resnet50_torch_state_dict = load_torch_state_dict
load_vgg19_bn_torch_state_dict = load_torch_state_dict
