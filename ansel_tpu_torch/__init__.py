"""ansel_tpu_torch — the raw development engine on PyTorch and CUDA.

A port of `ansel_tpu` (the JAX/Pallas package beside it, which stays the
reference) for one NVIDIA H100.  Plain tensor code is torch; the TPU's
Pallas kernels become hand-written CUDA kernels under `csrc/`, built by
nvcc at first use (`kernels/_build.py`).  It imports neither JAX nor
`ansel_tpu`.

Ported so far: the bench config-1 path (rawprepare, temperature,
highlights CLIP, RCD demosaic, exposure, colorin, channelmixerrgb,
filmicrgb AgX, colorout).  Anything else raises NotImplementedError
while the pipe is planned.
"""

__version__ = "0.1.0"

from .core.types import CFAPattern, Colorspace, ImageSpec, RawMeta, ROI  # noqa: F401
from .pipeline.engine import (  # noqa: F401
    CompiledPipe,
    HistoryItem,
    Pipeline,
    compile_pipeline,
)

# import op modules for registration side effects
from .ops import ALL_OPS  # noqa: F401
