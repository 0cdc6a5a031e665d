"""The Lightroom importer (`ansel_tpu_torch/io/lightroom.py`), the crawler's
Lightroom branch, the Piwigo exporter (`library/piwigo.py`) and the ΔE
metric (`utils/deltae.py`) against ansel_tpu on the CPU: the parsed
import field by field, its history rendered in both packages, the
crawler's library rows, the written-back sidecar (R19), the Piwigo
client's and `store_piwigo`'s calls against a loopback mock of ws.php,
and CIEDE2000 on seeded colours."""

import dataclasses
import json
import os
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

import ansel_tpu
import ansel_tpu_torch
from ansel_tpu.io import lightroom as ref_lr
from ansel_tpu.io import rawfile as ref_rawfile
from ansel_tpu.io import xmp as ref_xmp
from ansel_tpu.io.synthetic import synth_raw
from ansel_tpu.library import db as ref_db
from ansel_tpu.library import piwigo as ref_piwigo
from ansel_tpu.library.crawler import crawl as ref_crawl
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu.pipeline import export as ref_export
from ansel_tpu.utils import deltae as ref_deltae
from ansel_tpu_torch.core.params import params_class
from ansel_tpu_torch.io import configs, lightroom
from ansel_tpu_torch.io.rawfile import load_raw
from ansel_tpu_torch.io.xmp import parse_xmp
from ansel_tpu_torch.library import piwigo
from ansel_tpu_torch.library.crawler import crawl
from ansel_tpu_torch.library.db import Library
from ansel_tpu_torch.pipeline import engine
from ansel_tpu_torch.pipeline.export import ExportSettings, export_image
from ansel_tpu_torch.utils import deltae

sys.path.insert(0, os.path.dirname(__file__))
from test_lightroom import LR_XMP  # noqa: E402
from test_torch_blend import share_rcd  # noqa: E402

torch.set_num_threads(1)

# the Lightroom history at 96 x 160, the JAX pipe handed the port's RCD
# (R3: the packages' CPU RCDs differ on a border that clipping's rotation
# carries into the frame): XLA's and torch's powf/log on the CPU differ
# by an ulp in the tone curve and colour zones, and the grain's normals
# by 5e-7 (8.6e-6 measured over the whole frame)
LR_RENDER_TOL = 5e-5
# the history after the library and its written-back sidecar against
# the parsed one: the database stores each item's params as the op's
# struct, where the parsed dicts fill in the op's defaults for the image
# (1.5e-6 measured)
ROUNDTRIP_TOL = 1.0 / 255.0
FRAME19 = dict(h=64, w=96, hx=60, wx=96)   # config 19's roll, cut to size


def test_the_config19_sidecar_is_tests_lr_xmp():
    assert configs.LIGHTROOM19 == LR_XMP


def _plain(item):
    return (item.op, item.params, item.version, item.enabled,
            item.iop_order, item.multi_priority, item.blend_params)


@pytest.mark.parametrize("source", ["text", "path"])
def test_parse_equals_jax_field_by_field(source, tmp_path):
    text = LR_XMP
    if source == "path":
        text = str(tmp_path / "lr.xmp")
        with open(text, "w") as f:
            f.write(LR_XMP)
    got, want = lightroom.parse_lightroom_xmp(text), \
        ref_lr.parse_lightroom_xmp(text)
    assert [_plain(h) for h in got.history] \
        == [_plain(h) for h in want.history]
    assert [h.op for h in got.history] == [
        "exposure", "clipping", "flip", "grain", "vignette", "tonecurve",
        "colorzones", "splittoning"]
    assert (got.rating, got.color_label, got.tags) \
        == (want.rating, want.color_label, want.tags) \
        == (4, "Red", ["alps", "ski"])
    assert lightroom.is_lightroom_xmp(LR_XMP) \
        and ref_lr.is_lightroom_xmp(LR_XMP)


def test_a_darktable_sidecar_is_not_lightroom(tmp_path):
    from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp

    path = str(tmp_path / "dt.xmp")
    write_xmp(path, XMPDocument(history=configs.history(1)))
    with open(path) as f:
        text = f.read()
    assert not lightroom.is_lightroom_xmp(text)
    assert not ref_lr.is_lightroom_xmp(text)


@pytest.fixture
def shared_rcd(monkeypatch):
    """The JAX pipes with the port's RCD twin (R3), compiled anew."""
    share_rcd(monkeypatch)
    monkeypatch.setattr(ref_engine, "_COMPILE_CACHE", {})


def test_the_history_renders_as_the_jax_package(shared_rcd):
    raw, meta, _ = synth_raw(h=96, w=160)
    got = ansel_tpu_torch.compile_pipeline(
        meta, lightroom.parse_lightroom_xmp(LR_XMP).history,
        device="cpu").output_array(raw)
    want = np.asarray(ansel_tpu.compile_pipeline(
        meta, ref_lr.parse_lightroom_xmp(LR_XMP).history).output_array(raw))
    # flip swaps the axes; clipping plans on the sensor frame (R9)
    assert got.shape == want.shape == (3, 82, 139)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LR_RENDER_TOL


@pytest.fixture
def roll19(tmp_path):
    return configs.write_roll19(str(tmp_path / "film"), **FRAME19)


def test_the_crawler_imports_the_roll_as_the_jax_crawler(roll19):
    folder = os.path.dirname(roll19[0])
    lib, ref = Library(), ref_db.Library()
    ids, ref_ids = lib.import_film_roll(folder), ref.import_film_roll(folder)
    assert crawl(lib).reimported == ids
    assert ref_crawl(ref).reimported == ref_ids
    for i, j in zip(ids, ref_ids):
        got, want = lib.read_history(i), ref.read_history(j)
        # the port's library names the version of the class that encoded
        # each item, where the JAX package's stores none (R19)
        assert [h.version for h in want] == [None] * 8
        assert [h.version for h in got] \
            == [params_class(h.op).op_version for h in got]
        assert [_plain(dataclasses.replace(h, version=None)) for h in got] \
            == [_plain(h) for h in want]
        assert len(got) == 8
        assert lib.rating(i) == ref.rating(j) == 4
        assert lib.image_tags(i) == ref.image_tags(j) == ["alps", "ski"]


def test_the_written_back_sidecar_exports_the_lightroom_history(roll19):
    """A second crawl writes the imported history back over the
    Lightroom sidecars, each item at the version of the class that
    encoded it; the export of each image renders the parsed Lightroom
    history.  The JAX package's library stores no version, so its
    sidecar names clipping v1, which no params class decodes (R19)."""
    folder = os.path.dirname(roll19[0])
    lib = Library()
    ids = lib.import_film_roll(folder)
    assert crawl(lib).reimported == ids
    assert crawl(lib, write_back=True).written_back == ids
    history = lightroom.parse_lightroom_xmp(LR_XMP).history
    for path in roll19:
        doc = parse_xmp(path + ".xmp")
        assert [h.op for h in doc.history] == [h.op for h in history]
        assert [h.version for h in doc.history] \
            == [params_class(h.op).op_version for h in history]
        raw, meta = load_raw(path)
        got = export_image(raw, meta, xmp_path=path + ".xmp", device="cpu")
        want = engine.CompiledPipe(engine.Pipeline(
            meta, history, device="cpu")).output_array(raw)
        assert np.abs(got - want).max() <= ROUNDTRIP_TOL
    ref = ref_db.Library()
    j = ref.import_film_roll(folder)[0]
    ref.write_history(j, ref_lr.parse_lightroom_xmp(LR_XMP).history)
    path = str(roll19[0]) + ".ref.xmp"
    ref_xmp.write_xmp(path, ref_xmp.XMPDocument(history=ref.read_history(j)))
    clip = next(h for h in ref_xmp.parse_xmp(path).history
                if h.op == "clipping")
    assert clip.version == 1
    with pytest.raises(KeyError, match="clipping v1"):
        ref_export.export_image(*ref_rawfile.load_raw(roll19[0]),
                                xmp_path=path)


class MockPiwigo(BaseHTTPRequestHandler):
    """tests/test_piwigo.py's loopback ws.php, copied."""

    calls = []  # (method, args-dict-ish) log shared across the test

    def log_message(self, *a):
        pass

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        if ctype.startswith("multipart/form-data"):
            fields = self._parse_multipart(body, ctype)
        else:
            fields = {k: v[0] for k, v in
                      urllib.parse.parse_qs(body.decode()).items()}
        method = fields.get("method", "")
        MockPiwigo.calls.append((method, fields))
        out = {"stat": "ok", "result": {}}
        if method == "pwg.session.login":
            if fields.get("password") != "hunter2":
                out = {"stat": "fail", "message": "bad credentials"}
        elif method == "pwg.session.getStatus":
            out["result"] = {"pwg_token": "tok123"}
        elif method == "pwg.categories.getList":
            out["result"] = {"categories": [
                {"id": 7, "name": "Travel", "fullname": "Travel"}]}
        elif method == "pwg.categories.add":
            out["result"] = {"id": 42}
        elif method == "pwg.images.addSimple":
            assert "__file__" in fields, "upload must carry the image part"
            out["result"] = {"image_id": 1001}
        payload = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    @staticmethod
    def _parse_multipart(body, ctype):
        boundary = ctype.split("boundary=")[1].encode()
        fields = {}
        for part in body.split(b"--" + boundary):
            if b"Content-Disposition" not in part:
                continue
            head, _, val = part.partition(b"\r\n\r\n")
            if b'name="image"' in head:
                fields["__file__"] = val.rstrip(b"\r\n")
                fields["__filename__"] = head.split(
                    b'filename="')[1].split(b'"')[0].decode()
            else:
                name = head.split(b'name="')[1].split(b'"')[0].decode()
                fields[name] = val.rstrip(b"\r\n").decode()
        return fields


@pytest.fixture()
def server():
    MockPiwigo.calls = []
    srv = HTTPServer(("127.0.0.1", 0), MockPiwigo)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def _session(module, server, img):
    MockPiwigo.calls = []
    client = module.PiwigoClient(server=server, username="alice",
                                 password="hunter2")
    client.login()
    albums = [(a.id, a.name, a.label) for a in client.albums()]
    new_id = client.create_album("Fresh", parent_id=7, private=True)
    image_id = client.upload(img, album_id=new_id, name="shot",
                             author="alice", description="a day",
                             tags="tpu")
    client.logout()
    return (client.pwg_token, albums, new_id, image_id,
            list(MockPiwigo.calls))


def test_the_piwigo_client_sends_what_the_jax_client_sends(server, tmp_path):
    img = tmp_path / "shot.jpg"
    img.write_bytes(b"\xff\xd8\xff\xdbjpegdata")
    got = _session(piwigo, server, str(img))
    want = _session(ref_piwigo, server, str(img))
    assert got == want
    assert got[:4] == ("tok123", [(7, "Travel", "Travel")], 42, 1001)
    assert [m for m, _ in got[4]] == [
        "pwg.session.login", "pwg.session.getStatus",
        "pwg.categories.getList", "pwg.categories.add",
        "pwg.images.addSimple", "pwg.images.uploadCompleted",
        "pwg.session.logout"]


def test_bad_credentials_and_urls(server):
    client = piwigo.PiwigoClient(server=server, username="alice",
                                 password="wrong")
    with pytest.raises(piwigo.PiwigoError, match="bad credentials"):
        client.login()
    for server_, user in (("piwigo.com", "bob"), ("http://x:1/z", "b"),
                          ("gallery.me", "b")):
        assert piwigo.PiwigoClient(server=server_, username=user).url \
            == ref_piwigo.PiwigoClient(server=server_, username=user).url


def test_store_piwigo_uploads_as_the_jax_package(server, roll19, tmp_path):
    """Both images of config 19's roll (their sidecars written back from
    the library, so darktable sidecars) exported to JPEG and uploaded to
    an album the mock lacks: the port's calls and fields equal the JAX
    package's but for the JPEG bytes, which carry each package's render
    (the JAX package stores the Bayer image alone: its X-Trans pipe
    compiles for seconds)."""
    folder = os.path.dirname(roll19[0])
    lib = Library()
    ids = lib.import_film_roll(folder)
    crawl(lib)
    crawl(lib, write_back=True)
    settings = ExportSettings(format="jpg")
    runs = []
    for module, library, imgids, kw in (
            (piwigo, lib, ids, dict(device="cpu")),
            (ref_piwigo, ref_db.Library(), ids[:1], {})):
        if module is ref_piwigo:
            library.import_film_roll(folder)
        MockPiwigo.calls = []
        client = module.PiwigoClient(server=server, username="alice",
                                     password="hunter2")
        out = tmp_path / module.__name__
        out.mkdir()
        uploaded = module.store_piwigo(
            library, imgids, client, "Lightroom", settings=settings,
            author="alice", tags="lr", tmp_dir=str(out), **kw)
        assert uploaded == [1001] * len(imgids)
        runs.append([(m, {k: v for k, v in f.items() if k != "__file__"})
                     for m, f in MockPiwigo.calls])
        files = [f["__file__"] for m, f in MockPiwigo.calls
                 if m == "pwg.images.addSimple"]
        assert [b[:2] for b in files] == [b"\xff\xd8"] * len(imgids)
    assert runs[0][:6] == runs[1]
    methods = [m for m, _ in runs[0]]
    assert methods == ["pwg.session.login", "pwg.session.getStatus",
                       "pwg.categories.getList", "pwg.categories.add"] \
        + ["pwg.images.addSimple", "pwg.images.uploadCompleted"] * 2
    adds = [f for m, f in runs[0] if m == "pwg.images.addSimple"]
    assert [f["name"] for f in adds] == ["img000", "img001"]
    assert [f["__filename__"] for f in adds] == ["img000.jpg", "img001.jpg"]
    assert all(f["category"] == "42" and f["author"] == "alice"
               and f["tags"] == "lr" for f in adds)


def test_deltae_equals_the_jax_module():
    rng = np.random.default_rng(20)
    a = rng.uniform(-0.05, 1.05, (3, 24, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.02, a.shape), 0.0, 1.0).astype(
        np.float32)
    lab = deltae.srgb_to_lab(a.transpose(1, 2, 0))
    assert np.array_equal(lab, ref_deltae.srgb_to_lab(a.transpose(1, 2, 0)))
    lab2 = deltae.srgb_to_lab(b.transpose(1, 2, 0))
    assert np.array_equal(deltae.ciede2000(lab, lab2),
                          ref_deltae.ciede2000(lab, lab2))
    assert deltae.deltae_stats(a, b) == ref_deltae.deltae_stats(a, b)
    assert (deltae.MAX_DELTA_E, deltae.MAX_AVG_DELTA_E) \
        == (ref_deltae.MAX_DELTA_E, ref_deltae.MAX_AVG_DELTA_E)
