"""Adversarial attacks (PyTorch): FGSM, reverse FGSM, the minimal flipping
eps, FGSM adversarial training and PGD. Counterpart of
``imagetransformations_tpu/attacks``."""

from imagetransformations_tpu_torch.attacks.fgsm import (  # noqa: F401
    adversarial_train_step,
    denormalize,
    fgsm_attack,
    minimal_epsilon,
    renormalize,
    reverse_fgsm,
)
from imagetransformations_tpu_torch.attacks.pgd import pgd_attack  # noqa: F401
