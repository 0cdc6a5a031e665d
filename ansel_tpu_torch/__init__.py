"""ansel_tpu_torch — the raw development engine on PyTorch and CUDA.

A port of `ansel_tpu` (the JAX/Pallas package beside it, which stays the
reference) for one NVIDIA H100.  Plain tensor code is torch; the TPU's
Pallas kernels become hand-written CUDA kernels under `csrc/`, built by
nvcc at first use (`kernels/_build.py`).  It imports neither JAX nor
`ansel_tpu`.

Ported: all 88 of the reference's ops, on the paths of bench configs
1-5 (a default develop; the high-ISO denoise stack; diffuse, toneequal
and the local Laplacian at 45 MP; X-Trans Markesteijn and lens; the
library's batch export) and the port's configs 7-19; the camera raw
loader, the XMP sidecar reader and writer (`io/xmp.py`), the Lightroom
importer (`io/lightroom.py`), the headless export (`pipeline/export.py`)
and its CLI, the library (`library/`) with its scheduler (`control/`)
and the Piwigo exporter, the scopes (`pipeline/histogram.py`), and the
multi-device paths (`parallel/`: batch and row sharding on a mesh of
devices in one process):

    python -m ansel_tpu_torch.cli raw.npz shot.xmp out.png --bpp 16 --no-icc
    python -m ansel_tpu_torch.cli synth:6016x4000 shot.xmp out.png \
        --bpp 16 --no-icc --device cpu
    python -m ansel_tpu_torch.cli --generate-cache --library library.db

A branch not ported yet raises NotImplementedError while the pipe is
planned.  The entry points run on the CUDA card unless the caller passes
device="cpu" (`--device cpu` on the CLI).
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
