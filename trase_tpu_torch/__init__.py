"""trase_tpu_torch — the PyTorch / CUDA port of ``trase_tpu``.

A second package beside the JAX reference, mirroring its module names so
each counterpart is easy to find. Plain tensor code is PyTorch; every
Pallas kernel of trase_tpu is a hand-written CUDA kernel for Hopper: the
compositor and its gradient (``ops/rasterize_cuda.py`` +
``csrc/composite_fwd.cu``, ``csrc/composite_bwd.cu``) and the fused
deform MLP (``ops/mlp_cuda.py`` + ``csrc/deform_mlp.cu``). The package
imports torch and numpy only (sklearn for HDBSCAN clustering, scipy's
Rotation for the viewer's orbit camera and the Immersive converter, cv2
for the dataset converters; groundingdino and segment_anything for text
prompts and SAM masks where installed): never jax, flax or
``trase_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# float32 means float32, as trase_tpu/__init__.py sets for XLA: the
# covariance / projection / compositing math breaks at TF32 granularity.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> _torch.device:
    """The torch.device for `device`; raises when a CUDA device is asked
    for and none is present (no silent fallback to the CPU)."""
    dev = _torch.device(device)
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU")
    return dev
