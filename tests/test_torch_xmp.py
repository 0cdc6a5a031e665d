"""The port's XMP reader and writer (ElementTree) and its blend-parameter
and mask-form codecs against ansel_tpu's (lxml) on the CPU.  Every field
of `parse_xmp` equals the JAX package's on the inline sidecars of
tests/test_xmp.py, on sidecars the JAX package's `write_xmp` wrote (one
with masks_history) and on the port's own; a history survives the round
trip in both directions.  Exact comparisons throughout: no arithmetic."""

import dataclasses
import struct

import pytest

from ansel_tpu.core.params import xmp_encode
from ansel_tpu.io import xmp as ref_xmp
from ansel_tpu.ops.exposure import ExposureParams
from ansel_tpu.ops.filmicrgb import FilmicParams
from ansel_tpu.pipeline import blend as ref_blend
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu.pipeline import masks as ref_masks
from ansel_tpu_torch.io import configs
from ansel_tpu_torch.io import xmp
from ansel_tpu_torch.pipeline import blend, masks
from ansel_tpu_torch.pipeline.engine import HistoryItem


def _blob(exposure, compress):
    return xmp_encode(ExposureParams.codec.encode(
        ExposureParams(exposure=exposure)), compress=compress)


MODERN = f"""<?xpacket begin="" id="W5M0MpCehiHzreSzNTczkc9d"?>
<x:xmpmeta xmlns:x="adobe:ns:meta/">
 <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
  <rdf:Description rdf:about=""
    xmlns:darktable="http://darktable.sf.net/"
    xmlns:xmp="http://ns.adobe.com/xap/1.0/"
    xmp:Rating="3"
    darktable:xmp_version="5"
    darktable:history_end="1"
    darktable:iop_order_version="2">
   <darktable:iop_order_list>rawprepare,0,demosaic,0</darktable:iop_order_list>
   <darktable:history>
    <rdf:Seq>
     <rdf:li
       darktable:operation="exposure"
       darktable:enabled="1"
       darktable:modversion="6"
       darktable:params="{_blob(2.0, True)}"
       darktable:multi_priority="0"/>
     <rdf:li>
       <darktable:operation>exposure</darktable:operation>
       <darktable:enabled>0</darktable:enabled>
       <darktable:modversion>6</darktable:modversion>
       <darktable:params>{_blob(-1.0, False)}</darktable:params>
       <darktable:multi_priority>1</darktable:multi_priority>
       <darktable:iop_order>21.5</darktable:iop_order>
       <darktable:blendop_params>{xmp_encode(b"short blob")}</darktable:blendop_params>
     </rdf:li>
    </rdf:Seq>
   </darktable:history>
  </rdf:Description>
 </rdf:RDF>
</x:xmpmeta>
<?xpacket end="w"?>""".encode()

LEGACY = f"""<x:xmpmeta xmlns:x="adobe:ns:meta/">
 <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
  <rdf:Description rdf:about=""
    xmlns:darktable="http://darktable.sf.net/">
   <darktable:history_modversion><rdf:Seq><rdf:li>6</rdf:li><rdf:li>6</rdf:li></rdf:Seq></darktable:history_modversion>
   <darktable:history_enabled><rdf:Seq><rdf:li>1</rdf:li><rdf:li>0</rdf:li></rdf:Seq></darktable:history_enabled>
   <darktable:history_operation><rdf:Seq><rdf:li>exposure</rdf:li><rdf:li>exposure</rdf:li></rdf:Seq></darktable:history_operation>
   <darktable:history_params><rdf:Seq><rdf:li>{_blob(0.5, False)}</rdf:li><rdf:li>0</rdf:li></rdf:Seq></darktable:history_params>
   <darktable:blendop_params><rdf:Bag><rdf:li>{xmp_encode(b"legacy blendop v7")}</rdf:li></rdf:Bag></darktable:blendop_params>
   <darktable:multi_priority><rdf:Seq><rdf:li>0</rdf:li><rdf:li>2</rdf:li></rdf:Seq></darktable:multi_priority>
  </rdf:Description>
 </rdf:RDF>
</x:xmpmeta>""".encode()


def _item(h):
    return (h.op, h.params, h.version, h.enabled, h.iop_order,
            h.multi_priority, h.blend_params)


def _form(f):
    return (f.id, f.type, f.name, f.version, [tuple(n) for n in f.nodes],
            tuple(f.src))


def _same(got, want):
    """Every field of two XMPDocuments, the port's and the JAX package's."""
    assert [_item(h) for h in got.history] == [_item(h) for h in want.history]
    for name in ("history_end", "iop_order_version", "iop_order_list",
                 "rating", "tags"):
        assert getattr(got, name) == getattr(want, name), name
    assert sorted(got.masks) == sorted(want.masks)
    for k in want.masks:
        assert _form(got.masks[k]) == _form(want.masks[k])


@pytest.mark.parametrize("data", [MODERN, LEGACY], ids=["modern", "legacy"])
def test_inline_sidecars_parse_like_the_jax_package(data):
    got, want = xmp.parse_xmp(data), ref_xmp.parse_xmp(data)
    _same(got, want)
    assert len(got.history) == 2


def test_inline_modern_fields():
    doc = xmp.parse_xmp(MODERN)
    assert (doc.history_end, doc.iop_order_version, doc.rating) == (1, 2, 3)
    assert doc.iop_order_list == "rawprepare,0,demosaic,0"
    a, b = doc.history
    assert ExposureParams.codec.decode(a.params).exposure == 2.0
    assert (b.enabled, b.multi_priority, b.iop_order) == (False, 1, 21.5)
    assert b.blend_params == b"short blob"


def _ref_forms():
    M = ref_masks
    return {
        11: M.Form(id=11, type=M.MASK_CIRCLE, name="spot",
                   nodes=[(0.4, 0.5, 0.1, 0.05)], src=(0.25, 0.75)),
        12: M.Form(id=12, type=M.MASK_ELLIPSE,
                   nodes=[(0.5, 0.5, 0.2, 0.1, 30.0, 0.05, 1)]),
        13: M.Form(id=13, type=M.MASK_GRADIENT,
                   nodes=[(0.5, 0.5, 10.0, 0.2, 0.5, 0.0, 0)]),
        14: M.Form(id=14, type=M.MASK_GROUP | M.MASK_CLONE,
                   nodes=[(11, 14, M.STATE_UNION, 1.0),
                          (12, 14, M.STATE_DIFFERENCE, 0.5)]),
        15: M.Form(id=15, type=M.MASK_POLYGON, nodes=[
            (0.1 * i, 0.2, 0.1, 0.2, 0.1, 0.2, 0.05, 0.05, 0)
            for i in range(4)]),
    }


def _ref_history():
    RI = ref_engine.HistoryItem
    inactive = ref_blend.BlendParams.codec.encode(ref_blend.BlendParams())
    active = ref_blend.BlendParams.codec.encode(ref_blend.BlendParams(
        mask_mode=ref_blend.MASK_ENABLED | ref_blend.MASK_SHAPE, mask_id=14,
        opacity=60.0))
    return [
        RI("exposure", ExposureParams(exposure=1.25), version=6,
           iop_order=21.0, blend_params=inactive),
        RI("filmicrgb", FilmicParams(contrast=1.5), version=5,
           blend_params=active, multi_priority=1),
        RI("exposure", {"exposure": -0.5}, version=6, enabled=False),
    ]


def test_a_jax_written_sidecar_with_masks_parses_alike(tmp_path):
    path = str(tmp_path / "ref.xmp")
    ref_xmp.write_xmp(path, ref_xmp.XMPDocument(
        history=_ref_history(), history_end=3, iop_order_version=2,
        masks=_ref_forms()))
    got, want = xmp.parse_xmp(path), ref_xmp.parse_xmp(path)
    _same(got, want)
    assert sorted(got.masks) == [11, 12, 13, 14, 15]
    assert got.masks[11].src == (0.25, 0.75)
    assert got.masks[14].nodes[1] == (12, 14, ref_masks.STATE_DIFFERENCE, 0.5)


def test_a_form_of_unknown_type_is_skipped_like_the_jax_package():
    NS = ref_xmp.NS
    good = xmp_encode(struct.pack("<4f", 0.5, 0.5, 0.1, 0.0))
    rows = "".join(
        f'<rdf:li darktable:mask_id="{mid}" darktable:mask_type="{t}" '
        f'darktable:mask_nb="1" darktable:mask_points="{good}"/>'
        for mid, t in ((1, masks.MASK_CLONE), (2, masks.MASK_CIRCLE),
                       (0, masks.MASK_CIRCLE)))
    data = (f'<x:xmpmeta xmlns:x="{NS["x"]}"><rdf:RDF xmlns:rdf="{NS["rdf"]}">'
            f'<rdf:Description xmlns:darktable="{NS["darktable"]}">'
            f'<darktable:masks_history><rdf:Seq>{rows}</rdf:Seq>'
            f'</darktable:masks_history></rdf:Description></rdf:RDF>'
            f'</x:xmpmeta>').encode()
    got, want = xmp.parse_xmp(data), ref_xmp.parse_xmp(data)
    _same(got, want)
    assert sorted(got.masks) == [2]


def _port_history():
    inactive = blend.BlendParams()
    return [HistoryItem(op, dict(p), blend_params=inactive)
            for op, p in configs.HISTORIES[8]] + [
        HistoryItem("exposure", ExposureParams.codec.encode(
            ExposureParams(exposure=0.3)), version=6, iop_order=30.5,
            multi_priority=1, enabled=False,
            blend_params=blend.BlendParams.codec.encode(
                blend.BlendParams(mask_mode=blend.MASK_ENABLED)))]


def _port_forms():
    return {f.id: masks.Form(f.id, f.type, f.name, f.version,
                             list(f.nodes), f.src)
            for f in _ref_forms().values()}


def test_the_port_writes_what_the_jax_package_reads(tmp_path):
    path = str(tmp_path / "port.xmp")
    xmp.write_xmp(path, xmp.XMPDocument(
        history=_port_history(), history_end=10, iop_order_version=5,
        masks=_port_forms()))
    got, want = xmp.parse_xmp(path), ref_xmp.parse_xmp(path)
    _same(got, want)
    assert [h.op for h in got.history] == \
        [op for op, _ in configs.HISTORIES[8]] + ["exposure"]
    assert (got.history_end, got.iop_order_version) == (10, 5)
    inactive = blend.BlendParams.codec.encode(blend.BlendParams())
    assert all(h.blend_params == inactive for h in got.history[:-1])
    # params written from dicts decode to the op's latest struct
    from ansel_tpu_torch.core.params import decode_blob

    nl = decode_blob("nlmeans", got.history[4].version,
                     got.history[4].params)
    assert dataclasses.asdict(nl) == {"radius": 2.0, "strength": 50.0,
                                      "luma": 0.5, "chroma": 1.0}


def test_round_trip_both_ways(tmp_path):
    a, b = str(tmp_path / "a.xmp"), str(tmp_path / "b.xmp")
    # JAX writes, the port reads, the port writes, the JAX package reads
    ref_xmp.write_xmp(a, ref_xmp.XMPDocument(
        history=_ref_history(), history_end=2, masks=_ref_forms()))
    doc = xmp.parse_xmp(a)
    xmp.write_xmp(b, doc)
    _same(xmp.parse_xmp(b), ref_xmp.parse_xmp(a))
    _same(xmp.parse_xmp(b), ref_xmp.parse_xmp(b))
    # a plain history list is a document too
    xmp.write_xmp(b, _port_history())
    _same(xmp.parse_xmp(b), ref_xmp.parse_xmp(b))
    assert xmp.parse_xmp(b).history_end is None


def test_no_description_raises():
    data = b'<x:xmpmeta xmlns:x="adobe:ns:meta/"></x:xmpmeta>'
    with pytest.raises(ValueError):
        xmp.parse_xmp(data)


@pytest.mark.parametrize("bp", [
    dict(),
    dict(mask_mode=1, opacity=60.0, blend_mode=ref_blend.B_MULTIPLY),
    dict(mask_mode=4 | 1, blendif=0x3, blendif_parameters=tuple(
        0.1 * (i % 4) for i in range(64)), raster_mask_source="exposure"),
], ids=["default", "uniform", "parametric"])
def test_blend_params_codec_equals_the_jax_package(bp):
    ref = ref_blend.BlendParams(**bp)
    port = blend.BlendParams(**bp)
    raw = ref_blend.BlendParams.codec.encode(ref)
    assert blend.BlendParams.codec.encode(port) == raw
    assert dataclasses.asdict(blend.decode_blend_params(raw)) == \
        dataclasses.asdict(ref_blend.decode_blend_params(raw))
    assert blend.blend_is_active(port) == ref_blend.blend_is_active(ref) \
        == bool(bp.get("mask_mode"))


@pytest.mark.parametrize("raw", [None, b"", b"\0" * 8,
                                 b"\x07\0\0\0" + b"\0" * 300],
                         ids=["none", "empty", "short", "legacy-v7"])
def test_undecodable_blend_blobs_are_no_blend(raw):
    """A blob of an older blendop version (shorter than v11's 420 bytes)
    decodes to None in both packages: no blend, neither raised nor
    guessed."""
    assert blend.decode_blend_params(raw) is None
    assert ref_blend.decode_blend_params(raw) is None
    assert not blend.blend_is_active(blend.decode_blend_params(raw))


def test_mask_constants_and_node_codecs_equal_the_jax_package():
    for name in ("MASK_CIRCLE", "MASK_POLYGON", "MASK_GROUP", "MASK_CLONE",
                 "MASK_GRADIENT", "MASK_ELLIPSE", "MASK_BRUSH",
                 "MASKS_VERSION"):
        assert getattr(masks, name) == getattr(ref_masks, name), name
    assert masks._NODE_CODECS == ref_masks._NODE_CODECS
    for t in (1, 2, 4, 16, 32, 64, 4 | 8, 2 | 8):
        assert masks._base_type(t) == ref_masks._base_type(t)
    for f in _ref_forms().values():
        blob = f.points_blob()
        assert masks.decode_points(f.type, blob, len(f.nodes)) == \
            ref_masks.decode_points(f.type, blob, len(f.nodes))
        # a short blob stops at the last whole node
        assert masks.decode_points(f.type, blob[:-1], len(f.nodes)) == \
            ref_masks.decode_points(f.type, blob[:-1], len(f.nodes))
    for name in ("MASK_DISABLED", "MASK_ENABLED", "MASK_SHAPE",
                 "MASK_PARAMETRIC", "MASK_RASTER", "B_NORMAL2",
                 "B_HARMONIC_MEAN", "CS_RGB_SCENE", "BLENDIF_SIZE"):
        assert getattr(blend, name) == getattr(ref_blend, name), name
