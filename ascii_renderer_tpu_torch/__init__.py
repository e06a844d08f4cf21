"""ascii_renderer_tpu_torch — the PyTorch / CUDA port of ascii_renderer_tpu.

The JAX package beside this one is the reference; every public function
here keeps its JAX name and array shapes so tests can feed both packages
the same numpy inputs. Hand-written CUDA kernels live in ``ops/csrc`` next
to their plain-torch versions in ``ops/*.py``.

TF32 is switched off for the whole process at import: the raster and
glyph paths rely on exact float32 products (the same trap the JAX package
documents for bf16 folds in ``ops/mxu.py``), and TF32 keeps only ~10
mantissa bits, which would move near-edge triangle winners and shading.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ascii_renderer_tpu_torch.core.config import Config, default_config  # noqa: E402,F401
