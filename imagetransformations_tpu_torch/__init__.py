"""imagetransformations_tpu_torch — the PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``imagetransformations_tpu`` (the JAX reference).
It imports PyTorch and numpy, never JAX. Ported: ``build_chain_fn`` with
every op and route of the JAX dispatcher (fused blur -> rotate ->
grayscale for static and per-image angles, strict parity, affine-run
fusion, HWC and float32 input), ``fused_blur_rotate_image`` and
``fused_blur_rotate_batched`` at any angle and image size, the reference's
8-type sweep ``apply_all_transformations`` with every flag combination,
the warp ops ``apply_rotation``, ``random_zoom``, ``apply_shear`` and
``affine_warp``, and every Pallas entry point of the JAX package
(``ops.hopper``: ``blur_separable``, ``shear_rows``,
``shear_rows_per_image``, ``rotate_3shear``, ``blur_rotate_fused``, ...),
plus ``blur_separable_batched``, the per-image blur of the sweep; the
JAX package's whole per-op API (``ops`` exports its 31 names, among them
``center_crop``, ``perspective_warp``, ``apply_perspective``,
``perspective_coeffs``, ``sobel_edges``, ``pil_box_blur``,
``pil_gaussian_blur``, ``gaussian_noise_01`` and ``image_entropy``; and
``ops.warp.pil_resize``), ``ops.composite`` (background change, random crop, the
3-D-transform aliases), the 19 CIFAR-10-C generators of
``ops.corruptions`` with their dispatch ``evalx.harness.corrupt``; the
classifiers of ``models`` (CIFAR ResNet-20/56, SimpleCNN, the Bayesian
CNN, ResNet-18/50 and VGG-19-BN, with ``from_flax`` and the training
steps, ``swag_collect`` among them), every module of ``uq`` (the logit
metrics, calibration, ODIN, Mahalanobis, MC sampling, SWAG, SGLD, the
last-layer Laplace approximation, deep k-NN), the evaluation harness
(``evaluate_batched``, ``corruption_sweep``,
``analyze_uncertainty_thresholds``) with ``evalx.report`` and
``evalx.analysis``; the attacks (FGSM, reverse FGSM, PGD, the minimal
eps, adversarial training), the reverse-FGSM refinement ``adapt.refine``,
TENT with its entropy gate, TTA, MATTA, post-hoc calibration, AugMix,
the angelic patches and the evolutionary transform search (``adapt``),
checkpoints and profiling, the SWAG, refinement and TENT workflows; batch
sharding over a one-process device mesh (``pipeline.sharding``:
``sharded_chain_fn``, ``evaluate_sharded`` and the sweep's ``mesh=``) and
the row-sharded halo blur (``ops.sharded_stencil``); and the ``transform`` /
``chain`` / ``corrupt`` / ``sweep`` (also ``--data-parallel``) / ``report``
CLI.
Hand-written CUDA kernels in ``csrc/``, one or more for each of the JAX
package's twelve Pallas kernels, carry them on the card; they are built with
nvcc at first use.

- ``core``     : NHWC uint8 batch helpers, u8 quantizations, parameter grids.
- ``ops``      : elementwise, stencil, noise, histogram, affine warps,
                 PIL resize and LANCZOS scale, composites and the
                 corruption generators in plain PyTorch, the row-sharded
                 halo blur; ``ops.hopper`` holds the kernel wrappers, their
                 plain PyTorch versions and the build.
- ``pipeline`` : declarative op-chains, the 8-type batch sweep, folder I/O,
                 batch sharding over a one-process device mesh.
- ``models``   : the classifiers (NCHW, true f32: ``core.precision.full_f32``),
                 parameter conversion from and to flax, training steps.
- ``uq``       : uncertainty scores, calibration and ranking metrics, ODIN,
                 Mahalanobis, MC sampling, SWAG, SGLD, Laplace, k-NN.
- ``attacks``  : FGSM, reverse FGSM, PGD, adversarial training.
- ``adapt``    : reverse-FGSM refinement, TENT and its entropy gate, TTA,
                 MATTA / VATTA, post-hoc calibration, AugMix, angelic
                 patches, the evolutionary transform search.
- ``evalx``    : the corruption dispatch and sweep harness, reports, flip
                 analysis and failure heads.
- ``utils``    : typed configuration, the demo model of the CLI,
                 checkpoints, profiling.
"""

__version__ = "0.7.0"

from imagetransformations_tpu_torch.core.grids import PARAM_GRIDS  # noqa: F401
from imagetransformations_tpu_torch.core.image import (  # noqa: F401
    as_batch,
    as_float,
    to_uint8_rint,
    to_uint8_trunc,
)
from imagetransformations_tpu_torch.ops.hopper import (  # noqa: F401
    blur_rotate_fused,
    blur_separable,
    blur_separable_batched,
    blur_to_sheared_rows,
    fused_blur_rotate_batched,
    fused_blur_rotate_image,
    rotate_3shear,
    shear_rows,
    shear_rows_per_image,
)
from imagetransformations_tpu_torch.ops.warp import (  # noqa: F401
    affine_warp,
    apply_rotation,
    apply_shear,
    random_zoom,
)
from imagetransformations_tpu_torch.pipeline.batch import apply_all_transformations  # noqa: F401
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn  # noqa: F401
