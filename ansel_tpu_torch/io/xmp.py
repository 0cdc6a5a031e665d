"""XMP sidecar history reader and writer (`ansel_tpu/io/xmp.py`), on the
standard library's `xml.etree.ElementTree` instead of lxml.

Reference: `src/common/exif.cc` (dt_exif_xmp_read, exif.cc:2650-3000).
Two formats:

  * legacy (xmp_version < 2): parallel rdf:Seq arrays
    darktable:history_operation / history_params / history_modversion /
    history_enabled / blendop_params / multi_priority (exif.cc:2688-2740)
  * modern: one darktable:history rdf:Seq whose rdf:li carry
    darktable:operation/enabled/modversion/params/multi_priority/
    iop_order/blendop_params as attributes or child elements
    (exif.cc:2858-2925)

plus history_end, iop_order_version, iop_order_list, xmp:Rating and the
drawn-mask forms of darktable:masks_history (exif.cc:3628-3662).  Params
payloads are hex or gz-base64 blobs (core/params.xmp_decode).
"""

from __future__ import annotations

import dataclasses
import struct
import xml.etree.ElementTree as ET
from typing import List, Optional

from ..core.params import xmp_decode, xmp_encode
from ..pipeline.engine import HistoryItem

NS = {
    "x": "adobe:ns:meta/",
    "rdf": "http://www.w3.org/1999/02/22-rdf-syntax-ns#",
    "darktable": "http://darktable.sf.net/",
    "exif": "http://ns.adobe.com/exif/1.0/",
    "xmp": "http://ns.adobe.com/xap/1.0/",
    "dc": "http://purl.org/dc/elements/1.1/",
    "lr": "http://ns.adobe.com/lightroom/1.0/",
}


def _q(prefix: str, name: str) -> str:
    return "{%s}%s" % (NS[prefix], name)


@dataclasses.dataclass
class XMPDocument:
    history: List[HistoryItem]
    history_end: Optional[int] = None
    iop_order_version: Optional[int] = None
    iop_order_list: Optional[str] = None
    rating: Optional[int] = None
    tags: List[str] = dataclasses.field(default_factory=list)
    # drawn-mask forms keyed by mask id (darktable:masks_history)
    masks: dict = dataclasses.field(default_factory=dict)


def _strip_xpacket(data: bytes) -> bytes:
    """The x:xmpmeta element alone: sidecars may carry <?xpacket?>
    processing instructions and an XML declaration around it."""
    start = data.find(b"<x:xmpmeta")
    end = data.rfind(b"</x:xmpmeta>")
    if start >= 0 and end >= 0:
        return data[start: end + len(b"</x:xmpmeta>")]
    return data


def _seq_items(desc, name):
    node = desc.find(_q("darktable", name))
    if node is None:
        return None
    items = node.findall(f"{_q('rdf', 'Seq')}/{_q('rdf', 'li')}")
    if not items:
        items = node.findall(f"{_q('rdf', 'Bag')}/{_q('rdf', 'li')}")
    return items


def _li_get(li, name):
    """Attribute or child-element access on an rdf:li."""
    v = li.get(_q("darktable", name))
    if v is not None:
        return v
    child = li.find(_q("darktable", name))
    return child.text if child is not None else None


def parse_xmp(path_or_bytes) -> XMPDocument:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    root = ET.fromstring(_strip_xpacket(data))
    descs = root.findall(f".//{_q('rdf', 'Description')}")
    if not descs:
        raise ValueError("no rdf:Description in XMP")

    doc = XMPDocument(history=[])
    for desc in descs:
        _parse_description(desc, doc)
    return doc


def _parse_description(desc, doc: XMPDocument) -> None:
    def attr_or_child(name, ns="darktable"):
        v = desc.get(_q(ns, name))
        if v is not None:
            return v
        child = desc.find(_q(ns, name))
        return child.text if child is not None else None

    v = attr_or_child("history_end")
    if v is not None:
        doc.history_end = int(v)
    v = attr_or_child("iop_order_version")
    if v is not None:
        doc.iop_order_version = int(v)
    v = attr_or_child("iop_order_list")
    if v is not None:
        doc.iop_order_list = v
    v = attr_or_child("Rating", ns="xmp")
    if v is not None:
        doc.rating = int(v)

    # --- drawn masks (darktable:masks_history, exif.cc:3628-3662) -----------
    for li in _seq_items(desc, "masks_history") or []:
        try:
            from ..pipeline.masks import Form, decode_points

            mid = int(_li_get(li, "mask_id") or 0)
            mtype = int(_li_get(li, "mask_type") or 0)
            ptext = _li_get(li, "mask_points")
            nb = int(_li_get(li, "mask_nb") or 0)
            if not mid or not mtype or not ptext:
                continue
            blob = xmp_decode(ptext)
            src = (0.0, 0.0)
            stext = _li_get(li, "mask_src")
            if stext:
                sblob = xmp_decode(stext)
                if len(sblob) >= 8:
                    src = struct.unpack("<2f", sblob[:8])
            doc.masks[mid] = Form(
                id=mid, type=mtype,
                name=_li_get(li, "mask_name") or "",
                version=int(_li_get(li, "mask_version") or 6),
                nodes=decode_points(mtype, blob, nb), src=src)
        except (ValueError, KeyError):
            continue

    # --- modern format: darktable:history Seq of structured li --------------
    items = _seq_items(desc, "history")
    if items:
        for li in items:
            opname = _li_get(li, "operation")
            if not opname:
                continue
            params_text = _li_get(li, "params")
            blend_text = _li_get(li, "blendop_params")
            iop_order = _li_get(li, "iop_order")
            doc.history.append(
                HistoryItem(
                    op=opname,
                    params=xmp_decode(params_text) if params_text else None,
                    version=int(_li_get(li, "modversion") or 1),
                    enabled=(_li_get(li, "enabled") or "0") in ("1", "true",
                                                                "True"),
                    iop_order=float(iop_order) if iop_order else None,
                    multi_priority=int(_li_get(li, "multi_priority") or 0),
                    blend_params=(xmp_decode(blend_text) if blend_text
                                  else None),
                )
            )
        return

    # --- legacy format: parallel arrays --------------------------------------
    ops = _seq_items(desc, "history_operation")
    if not ops:
        return
    params = _seq_items(desc, "history_params") or []
    versions = _seq_items(desc, "history_modversion") or []
    enabled = _seq_items(desc, "history_enabled") or []
    blends = _seq_items(desc, "blendop_params") or []
    priorities = _seq_items(desc, "multi_priority") or []

    def txt(seq, i, default=None):
        return (seq[i].text if i < len(seq) and seq[i].text is not None
                else default)

    for i, li in enumerate(ops):
        ptext = txt(params, i)
        btext = txt(blends, i)
        doc.history.append(
            HistoryItem(
                op=li.text,
                params=xmp_decode(ptext) if ptext and ptext != "0" else None,
                version=int(txt(versions, i, "1")),
                enabled=txt(enabled, i, "0") in ("1", "true", "True"),
                multi_priority=int(txt(priorities, i, "0")),
                blend_params=(xmp_decode(btext) if btext and btext != "0"
                              else None),
            )
        )


def _blob(value) -> bytes:
    """Raw bytes, or a params dataclass encoded by its codec."""
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    return value.codec.encode(value)


def write_xmp(path: str, doc) -> None:
    """Write a modern-format sidecar the reference can read back
    (dt_exif_xmp_write counterpart).  `doc` may be an XMPDocument or a
    plain history list; blend params may be bytes or a BlendParams."""
    if isinstance(doc, (list, tuple)):
        doc = XMPDocument(history=list(doc))
    # ElementTree's prefix table is the process's: the prefixes are the
    # standard ones, so registering them again changes nothing else
    for p, uri in NS.items():
        ET.register_namespace(p, uri)
    root = ET.Element(_q("x", "xmpmeta"))
    rdf = ET.SubElement(root, _q("rdf", "RDF"))
    desc = ET.SubElement(rdf, _q("rdf", "Description"))
    desc.set(_q("rdf", "about"), "")
    desc.set(_q("darktable", "xmp_version"), "5")
    if doc.history_end is not None:
        desc.set(_q("darktable", "history_end"), str(doc.history_end))
    if doc.iop_order_version is not None:
        desc.set(_q("darktable", "iop_order_version"),
                 str(doc.iop_order_version))
    hist = ET.SubElement(desc, _q("darktable", "history"))
    seq = ET.SubElement(hist, _q("rdf", "Seq"))
    for item in doc.history:
        li = ET.SubElement(seq, _q("rdf", "li"))
        li.set(_q("darktable", "operation"), item.op)
        li.set(_q("darktable", "enabled"), "1" if item.enabled else "0")
        blob = item.params
        if isinstance(blob, dict):
            from ..core.params import params_class

            cls = params_class(item.op, item.version)
            blob = cls(**blob)
        version = item.version
        if version is None:
            version = getattr(blob, "op_version", None) or 1
        li.set(_q("darktable", "modversion"), str(version))
        li.set(_q("darktable", "multi_priority"), str(item.multi_priority))
        if item.iop_order is not None:
            li.set(_q("darktable", "iop_order"), repr(float(item.iop_order)))
        if blob is not None:
            li.set(_q("darktable", "params"), xmp_encode(_blob(blob)))
        if item.blend_params is not None:
            li.set(_q("darktable", "blendop_params"),
                   xmp_encode(_blob(item.blend_params)))
    if doc.masks:
        mh = ET.SubElement(desc, _q("darktable", "masks_history"))
        mseq = ET.SubElement(mh, _q("rdf", "Seq"))
        for num, form in enumerate(doc.masks.values()):
            li = ET.SubElement(mseq, _q("rdf", "li"))
            li.set(_q("darktable", "mask_num"), str(num))
            li.set(_q("darktable", "mask_id"), str(form.id))
            li.set(_q("darktable", "mask_type"), str(form.type))
            li.set(_q("darktable", "mask_name"), form.name or "mask")
            li.set(_q("darktable", "mask_version"), str(form.version))
            li.set(_q("darktable", "mask_points"),
                   xmp_encode(form.points_blob()))
            li.set(_q("darktable", "mask_nb"), str(len(form.nodes)))
            li.set(_q("darktable", "mask_src"), xmp_encode(form.src_blob()))
    ET.indent(root)
    data = ET.tostring(root, encoding="utf-8", xml_declaration=False)
    with open(path, "wb") as f:
        f.write(data + b"\n")
