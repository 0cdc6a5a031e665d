"""Styles — named history fragments (.dtstyle import, export and apply),
on the standard library's `xml.etree.ElementTree` instead of lxml (port
of `ansel_tpu/io/styles.py`).

Reference: `ansel/src/common/styles.c`: an XML `<darktable_style>` with
an `iop_list` (the per-image module order, multi-instances included) and
`<plugin>` entries carrying the op name, encoded params, blend params and
the multi-instance priority and name.  Applying a style merges its items
onto a history stack: an item of the same op and priority replaces,
any other appends.
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as ET
from typing import List, Optional

from ..core.params import xmp_decode, xmp_encode
from ..pipeline.engine import HistoryItem


@dataclasses.dataclass
class Style:
    name: str
    description: str = ""
    items: List[HistoryItem] = dataclasses.field(default_factory=list)
    iop_list: Optional[str] = None


def parse_style(path_or_bytes) -> Style:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    root = ET.fromstring(data)
    info = root.find("info")
    style = Style(
        name=info.findtext("name", default=""),
        description=info.findtext("description", default=""),
        iop_list=info.findtext("iop_list"),
    )
    for plugin in root.find("style").findall("plugin"):
        op = plugin.findtext("operation")
        params_text = plugin.findtext("op_params")
        blend_text = plugin.findtext("blendop_params")
        style.items.append(HistoryItem(
            op=op,
            params=xmp_decode(params_text) if params_text else None,
            version=int(plugin.findtext("module") or 1),
            enabled=(plugin.findtext("enabled") or "1") == "1",
            multi_priority=int(plugin.findtext("multi_priority") or 0),
            blend_params=(xmp_decode(blend_text) if blend_text else None),
        ))
    return style


def apply_style(history: List[HistoryItem], style: Style) -> List[HistoryItem]:
    """Merge style items onto a history stack (the reference's
    dt_styles_apply_to_image: the same op and priority replaces)."""
    out = list(history)
    for item in style.items:
        replaced = False
        for i, h in enumerate(out):
            if h.op == item.op and h.multi_priority == item.multi_priority:
                out[i] = item
                replaced = True
                break
        if not replaced:
            out.append(item)
    return out


def write_style(path: str, style: Style) -> None:
    root = ET.Element("darktable_style", version="1.0")
    info = ET.SubElement(root, "info")
    ET.SubElement(info, "name").text = style.name
    ET.SubElement(info, "description").text = style.description
    if style.iop_list:
        ET.SubElement(info, "iop_list").text = style.iop_list
    st = ET.SubElement(root, "style")
    for i, item in enumerate(style.items):
        pl = ET.SubElement(st, "plugin")
        ET.SubElement(pl, "num").text = str(i)
        ET.SubElement(pl, "module").text = str(item.version or 1)
        ET.SubElement(pl, "operation").text = item.op
        blob = item.params
        if blob is not None and not isinstance(blob, (bytes, bytearray)):
            blob = blob.codec.encode(blob)
        ET.SubElement(pl, "op_params").text = (
            xmp_encode(bytes(blob)) if blob is not None else "")
        ET.SubElement(pl, "enabled").text = "1" if item.enabled else "0"
        if item.blend_params is not None:
            ET.SubElement(pl, "blendop_params").text = xmp_encode(
                bytes(item.blend_params))
            ET.SubElement(pl, "blendop_version").text = "11"
        ET.SubElement(pl, "multi_priority").text = str(item.multi_priority)
        ET.SubElement(pl, "multi_name").text = ""
    with open(path, "wb") as f:
        f.write(ET.tostring(root, encoding="UTF-8", xml_declaration=True))
