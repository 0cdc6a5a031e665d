"""`.anselnn` neural model container IO (`ansel_tpu/io/anselnn.py`,
copied: numpy only, so a file either package writes loads bit for bit in
the other).

Reference: `ansel/src/common/nn_model.{h,c}` (format spec
nn_model.h:30-46): magic "ANSELDN1", uint32 JSON header length, JSON
{"cfg": {...}, "tensors": [{"name","shape","offset","size"}]}, float32
payload.  Tensor names are pytorch state-dict names (nn_model.c:124-216):
  {stage}enc.{l}.0|2.weight/.bias, {stage}down.{l}.*, {stage}bot.0|2.*,
  {stage}up.{i}.*, {stage}dec.{i}.0|2.*, {stage}head.*
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Dict, Tuple

import numpy as np

MAGIC = b"ANSELDN1"


@dataclasses.dataclass
class NNModel:
    cfg: dict
    tensors: Dict[str, np.ndarray]

    @property
    def arch(self) -> str:
        return self.cfg.get("arch", "unet")

    @property
    def base(self) -> int:
        return int(self.cfg["base"])

    @property
    def depth(self) -> int:
        return int(self.cfg["depth"])

    @property
    def in_channels(self) -> int:
        return int(self.cfg["in_channels"])

    @property
    def out_channels(self) -> int:
        return int(self.cfg["out_channels"])

    # --- multi-scale ("unet-ms") accessors (nn_model.h:79-84) ---

    @property
    def has_coarse(self) -> bool:
        return self.arch == "unet-ms"

    @property
    def anchor(self) -> int:
        """Low-band fusion anchor scale (nn_model.c:357-360; unet-ms
        only)."""
        return int(self.cfg.get("anchor", 0)) if self.has_coarse else 0

    def bin_for(self, is_xtrans: bool) -> int:
        if not self.has_coarse:
            return 1
        b = self.cfg.get("bin", {})
        return int(b.get("xtrans" if is_xtrans else "bayer",
                         6 if is_xtrans else 4))

    def stage(self, name: str) -> "NNModel":
        """-> the fine/coarse sub-net as a standalone NNModel (tensor
        names are prefixed "fine."/"coarse." in the file,
        nn_model.c:178)."""
        if not self.has_coarse:
            return self
        prefix = name + "."
        return NNModel(
            cfg=dict(self.cfg[name], arch="unet"),
            tensors={k[len(prefix):]: v
                     for k, v in self.tensors.items()
                     if k.startswith(prefix)})


def load_anselnn(path: str) -> NNModel:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != MAGIC:
        raise ValueError(f"{path}: not an ANSELDN1 file")
    (hlen,) = struct.unpack("<I", data[8:12])
    header = json.loads(data[12 : 12 + hlen].decode("utf-8"))
    payload = data[12 + hlen :]
    tensors = {}
    for t in header["tensors"]:
        off, size = int(t["offset"]), int(t["size"])
        arr = np.frombuffer(payload[off : off + size], dtype="<f4")
        tensors[t["name"]] = arr.reshape(t["shape"]).copy()
    return NNModel(cfg=header["cfg"], tensors=tensors)


def save_anselnn(path: str, cfg: dict, tensors: Dict[str, np.ndarray]) -> None:
    entries = []
    blobs = []
    off = 0
    for name, arr in tensors.items():
        a = np.asarray(arr, "<f4")
        entries.append({"name": name, "shape": list(a.shape),
                        "offset": off, "size": a.nbytes})
        blobs.append(a.tobytes())
        off += a.nbytes
    header = json.dumps({"cfg": cfg, "tensors": entries}).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for b in blobs:
            f.write(b)


def random_unet(base: int = 8, depth: int = 2, in_ch: int = 5,
                out_ch: int = 1, seed: int = 0) -> NNModel:
    """Tiny randomly-initialized model for tests (matches _wire_conv's
    naming contract, nn_model.c:186-218)."""
    rng = np.random.default_rng(seed)

    def conv(out_c, in_c, k):
        w = (rng.standard_normal((out_c, in_c, k, k)) * 0.05).astype("<f4")
        b = np.zeros(out_c, "<f4")
        return w, b

    tensors = {}

    def put(name, out_c, in_c, k):
        w, b = conv(out_c, in_c, k)
        tensors[name + ".weight"] = w
        tensors[name + ".bias"] = b

    cin = in_ch
    for l in range(depth):
        w = base << l
        put(f"enc.{l}.0", w, cin, 3)
        put(f"enc.{l}.2", w, w, 3)
        put(f"down.{l}", w, w, 2)
        cin = w
    wb = base << depth
    put("bot.0", wb, base << (depth - 1), 3)
    put("bot.2", wb, wb, 3)
    for i in range(depth):
        w_skip = base << (depth - 1 - i)
        put(f"up.{i}", w_skip, w_skip << 1, 1)
        put(f"dec.{i}.0", w_skip, 2 * w_skip, 3)
        put(f"dec.{i}.2", w_skip, w_skip, 3)
    put("head", out_ch, base, 3)
    cfg = {"arch": "unet", "base": base, "depth": depth,
           "in_channels": in_ch, "out_channels": out_ch}
    return NNModel(cfg=cfg, tensors=tensors)


def random_unet_ms(base: int = 8, depth: int = 2, seed: int = 0) -> NNModel:
    """Tiny multi-scale model for tests: fine net (8 in: mosaic + one-hot
    + sigma + 3 coarse guide planes) + coarse net (6 in: RGB + sigmas,
    3 out) with "fine."/"coarse." tensor prefixes (nn_model.c:300-380)."""
    fine = random_unet(base, depth, in_ch=8, out_ch=1, seed=seed)
    coarse = random_unet(base, depth, in_ch=6, out_ch=3, seed=seed + 1)
    tensors = {f"fine.{k}": v for k, v in fine.tensors.items()}
    tensors.update({f"coarse.{k}": v for k, v in coarse.tensors.items()})
    cfg = {"arch": "unet-ms", "bin": {"bayer": 4, "xtrans": 6},
           "anchor": 1,
           "fine": dict(fine.cfg), "coarse": dict(coarse.cfg)}
    return NNModel(cfg=cfg, tensors=tensors)
