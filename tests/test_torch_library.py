"""The library (`ansel_tpu_torch/library/`, `io/exif.py`, `io/gpx.py`) and
its batch export on the port's render, against ansel_tpu on the CPU: the
database rows of one import, a library.db written by either package
opened in the other, the v1 -> v2 migration, collections, variables, the
crawler, presets, undo, EXIF, GPX, the gallery and the thumbnail cache;
`batch_export` of a 4-image mixed catalog (config 5's roll at 64 x 96,
Bayer and X-Trans) with `device="cpu"`, each array within the display
quantum of the JAX package's export of the same file (the JAX pipe handed
the port's RCD and Markesteijn twins, as tests/test_torch_blend.py does:
the packages' CPU demosaics differ on a border that fills most of so
small a frame), each JPEG equal to the port's own `write_image` of its
array; and the CLI's `--generate-cache` and `--ingest-lensfun` on the
port.  tests/test_library.py's and tests/test_cli_apps.py's
`--generate-cache` cases run on the port too."""

import datetime as dt
import os
import sqlite3
import tarfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ansel_tpu.core import conf as ref_conf
from ansel_tpu.io import exif as ref_exif
from ansel_tpu.io import gpx as ref_gpx
from ansel_tpu.io import lensfun as ref_lensfun
from ansel_tpu.kernels import markesteijn as ref_mark
from ansel_tpu.kernels import rcd as ref_rcd
from ansel_tpu.library import db as ref_db
from ansel_tpu.library import mipmap as ref_mipmap
from ansel_tpu.library import presets as ref_presets
from ansel_tpu.library import variables as ref_variables
from ansel_tpu.library.collections import Collection as RefCollection
from ansel_tpu.library.crawler import crawl as ref_crawl
from ansel_tpu.pipeline import engine as ref_engine
from ansel_tpu.pipeline.export import export_image as ref_export_image
from ansel_tpu_torch import cli
from ansel_tpu_torch.core import conf
from ansel_tpu_torch.core.types import CFAPattern
from ansel_tpu_torch.io import configs, encode, exif, gpx, lensfun
from ansel_tpu_torch.io.rawfile import load_raw, save_raw
from ansel_tpu_torch.io.synthetic import synth_raw
from ansel_tpu_torch.io.xmp import XMPDocument, write_xmp
from ansel_tpu_torch.kernels import markesteijn, rcd
from ansel_tpu_torch.library import Library
from ansel_tpu_torch.library import mipmap, presets
from ansel_tpu_torch.library.collections import Collection
from ansel_tpu_torch.library.crawler import crawl
from ansel_tpu_torch.library.export import batch_export
from ansel_tpu_torch.library.variables import expand
from ansel_tpu_torch.pipeline.engine import HistoryItem
from ansel_tpu_torch.pipeline.export import ExportSettings, export_image

torch.set_num_threads(1)

DISPLAY_QUANTUM = 1.0 / 255.0
CAT_H, CAT_W = 64, 96
# columns whose values hold a clock reading, not the import's content
CLOCK_COLUMNS = {"access_timestamp", "import_timestamp", "change_timestamp"}


@pytest.fixture
def film(tmp_path):
    d = tmp_path / "roll_a"
    d.mkdir()
    for name in ("img_0001.dng", "img_0002.dng", "other.txt"):
        (d / name).write_bytes(b"II*\x00\x08\x00\x00\x00\x00\x00")
    return str(d)


def _rows(con, table):
    con.row_factory = sqlite3.Row
    out = []
    for r in con.execute(f"SELECT * FROM {table} ORDER BY rowid"):
        out.append({k: r[k] for k in r.keys() if k not in CLOCK_COLUMNS})
    return out


def _tables(con):
    return [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table' "
        "AND name NOT LIKE 'sqlite_%' ORDER BY name")]


def _fill(lib, folder, hist_item):
    """One import with ratings, labels, tags and a history."""
    ids = lib.import_film_roll(folder)
    lib.set_rating(ids[0], 4)
    lib.set_color_label(ids[1], 2)
    lib.attach_tag(ids[0], "travel|alps")
    lib.attach_tag(ids[1], "keep")
    lib.write_history(ids[0], [hist_item("exposure", {"exposure": 1.25}),
                               hist_item("vibrance", {"amount": 40.0})])
    return ids


def test_db_rows_of_one_import_equal_the_jax_package(film, tmp_path):
    import ansel_tpu

    ref = ref_db.Library(str(tmp_path / "ref.db"))
    port = Library(str(tmp_path / "port.db"))
    assert _fill(ref, film, ansel_tpu.HistoryItem) \
        == _fill(port, film, HistoryItem)
    assert _tables(ref.con) == _tables(port.con)
    schema = "SELECT sql FROM sqlite_master ORDER BY name"
    assert ref.con.execute(schema).fetchall() \
        == port.con.execute(schema).fetchall()
    for table in _tables(ref.con):
        assert _rows(ref.con, table) == _rows(port.con, table), table


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_library_db_opens_in_the_other_package(film, tmp_path, writer):
    import ansel_tpu

    path = str(tmp_path / "library.db")
    first, second = (ref_db.Library, Library) if writer == "jax" \
        else (Library, ref_db.Library)
    item = ansel_tpu.HistoryItem if writer == "jax" else HistoryItem
    lib = first(path)
    ids = _fill(lib, film, item)
    lib.close()
    other = second(path)
    assert other.images() == ids
    assert other.rating(ids[0]) == 4
    assert other.image_tags(ids[0]) == ["travel|alps"]
    assert other.image_path(ids[1]).endswith("img_0002.dng")
    hist = other.read_history(ids[0])
    assert [h.op for h in hist] == ["exposure", "vibrance"]
    from ansel_tpu_torch.core.params import decode_blob

    p = decode_blob("exposure", hist[0].version or 6, hist[0].params)
    assert abs(p.exposure - 1.25) < 1e-6
    coll = (RefCollection if writer == "port" else Collection)(tag="keep")
    assert coll.run(other) == [ids[1]]


@pytest.mark.parametrize("opener", ["jax", "port"])
def test_schema_v1_migrates_to_v2(tmp_path, opener):
    """Opening a v1 db adds the geo columns (database.c migrations), in
    either package."""
    path = str(tmp_path / "old.db")
    lib = Library(path)
    lib.con.execute("UPDATE db_info SET value='1' WHERE key='version'")
    for col in ("latitude", "longitude", "elevation"):
        lib.con.execute(f"ALTER TABLE images DROP COLUMN {col}")
    lib.con.commit()
    lib.close()
    lib2 = (ref_db.Library if opener == "jax" else Library)(path)
    cols = [r[1] for r in lib2.con.execute("PRAGMA table_info(images)")]
    assert "latitude" in cols and "elevation" in cols
    assert lib2.con.execute(
        "SELECT value FROM db_info WHERE key='version'").fetchone()[0] == "2"


def test_a_newer_db_is_refused(tmp_path):
    path = str(tmp_path / "new.db")
    Library(path).con.execute(
        "UPDATE db_info SET value='9' WHERE key='version'").connection \
        .commit()
    with pytest.raises(RuntimeError, match="newer"):
        Library(path)


def test_import_film_roll_and_exif_columns(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    assert len(ids) == 2  # .txt skipped
    assert lib.import_film_roll(film) == ids
    assert lib.image_path(ids[0]).endswith("img_0001.dng")


def test_ratings_labels_tags(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.set_rating(ids[0], 4)
    assert lib.rating(ids[0]) == 4
    lib.set_color_label(ids[0], 2)
    lib.attach_tag(ids[0], "travel|alps")
    lib.attach_tag(ids[1], "travel|sea")
    assert lib.image_tags(ids[0]) == ["travel|alps"]
    lib.detach_tag(ids[0], "travel|alps")
    assert lib.image_tags(ids[0]) == []


COLLECTIONS = [dict(min_rating=4), dict(tag="keep"),
               dict(filename_like="img_%"),
               dict(sort="filename", descending=True), dict(color_label=2),
               dict(camera="X-T5"), dict(iso=(800.0, 3200.0)),
               dict(rejected=False), dict(taken_after="2024:06:01"),
               dict(sort="rating")]


@pytest.mark.parametrize("kw", COLLECTIONS,
                         ids=[",".join(k) for k in COLLECTIONS])
def test_collections_equal_the_jax_package(film, kw):
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.set_rating(ids[0], 5)
    lib.set_color_label(ids[1], 2)
    lib.attach_tag(ids[1], "keep")
    lib.con.execute("UPDATE images SET maker='FUJI', model='X-T5', "
                    "iso=1600, datetime_taken='2024:06:01 10:30:00' "
                    "WHERE id=?", (ids[1],))
    want = RefCollection(**kw)
    assert Collection(**kw).query() == want.query()
    assert Collection(**kw).run(lib) == want.run(lib)


def test_collection_filters(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.set_rating(ids[0], 5)
    lib.attach_tag(ids[1], "keep")
    assert Collection(min_rating=4).run(lib) == [ids[0]]
    assert Collection(tag="keep").run(lib) == [ids[1]]
    assert Collection(filename_like="img_%").run(lib) == ids
    assert Collection(sort="filename", descending=True).run(lib) \
        == list(reversed(ids))


def test_history_roundtrip_via_db(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.write_history(ids[0], [HistoryItem("exposure", {"exposure": 1.25}),
                               HistoryItem("vibrance", {"amount": 40.0})])
    back = lib.read_history(ids[0])
    assert [h.op for h in back] == ["exposure", "vibrance"]
    from ansel_tpu_torch.core.params import decode_blob

    p = decode_blob("exposure", back[0].version or 6, back[0].params)
    assert abs(p.exposure - 1.25) < 1e-6


def test_crawler_reimports_newer_sidecar(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    write_xmp(lib.xmp_path(ids[0]), XMPDocument(
        history=[HistoryItem("exposure", {"exposure": 0.5})]))
    rep = crawl(lib)
    assert rep.reimported == [ids[0]]
    assert [h.op for h in lib.read_history(ids[0])] == ["exposure"]
    assert crawl(lib).reimported == []
    # the JAX package's crawler reads the port's sidecar alike
    ref = ref_db.Library()
    ref_ids = ref.import_film_roll(film)
    assert ref_crawl(ref).reimported == [ref_ids[0]]
    assert ref.read_history(ref_ids[0])[0].params \
        == lib.read_history(ids[0])[0].params


def test_crawler_writes_back_and_finds_missing_files(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.write_history(ids[1], [HistoryItem("exposure", {"exposure": 0.3})])
    os.remove(lib.image_path(ids[0]))
    rep = crawl(lib, write_back=True)
    assert rep.missing_files == [ids[0]] and rep.written_back == [ids[1]]
    assert os.path.exists(lib.xmp_path(ids[1]))


def test_crawler_refuses_a_lightroom_sidecar(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    with open(lib.xmp_path(ids[0]), "w") as f:
        f.write('<x:xmpmeta xmlns:x="adobe:ns:meta/"><rdf:RDF xmlns:rdf='
                '"http://www.w3.org/1999/02/22-rdf-syntax-ns#"><rdf:'
                'Description xmlns:crs="http://ns.adobe.com/camera-raw-'
                'settings/1.0/" crs:Exposure2012="+0.50"/></rdf:RDF>'
                '</x:xmpmeta>')
    with pytest.raises(NotImplementedError, match="Lightroom"):
        crawl(lib)


def test_variables_expansion_equals_the_jax_package(film):
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.set_rating(ids[0], 3)
    lib.con.execute(
        "UPDATE images SET datetime_taken='2024:06:01 10:30:00', "
        "iso=400, maker='FUJI', model='X-T5', exposure=0.004, "
        "aperture=5.6, focal_length=35 WHERE id=?", (ids[0],))
    lib.con.execute("INSERT INTO meta_data (id, key, value) VALUES "
                    "(?, 0, 'Alps')", (ids[0],))
    template = ("$(ROLL_NAME)/$(FILE_NAME)-$(EXIF_YEAR)$(EXIF_MONTH)"
                "-iso$(EXIF_ISO)-$(MODEL)-$(STARS)$(UNKNOWN)")
    assert expand(template, lib, ids[0]) \
        == "roll_a/img_0001-202406-iso400-X-T5-3"
    every = ("$(ID).$(VERSION).$(SEQUENCE).$(FILE_EXTENSION).$(MAKER)."
             "$(LENS).$(EXIF_EXPOSURE).$(EXIF_APERTURE)."
             "$(EXIF_FOCAL_LENGTH).$(EXIF_HOUR)$(EXIF_MINUTE)$(EXIF_SECOND)"
             ".$(TITLE).$(CREATOR)")
    assert expand(every, lib, ids[0], sequence=7) \
        == ref_variables.expand(every, lib, ids[0], sequence=7)


def _exif_jpeg(path):
    from PIL import Image

    img = Image.new("RGB", (8, 8))
    ex = Image.Exif()
    ex[0x010F] = "TestMaker"
    ex[0x0110] = "TestCam X"
    ex[0x8827] = 800
    ex[0x0132] = "2023:12:24 08:15:30"
    img.save(path, exif=ex)


def test_exif_reader_equals_the_jax_package(tmp_path):
    pytest.importorskip("PIL")
    p = str(tmp_path / "shot.jpg")
    _exif_jpeg(p)
    ex = exif.read_exif(p)
    assert (ex.maker, ex.model, ex.iso) == ("TestMaker", "TestCam X", 800)
    assert ex.datetime.startswith("2023:12:24")
    # a port export carries the raw's maker and model
    raw, meta, _ = synth_raw(h=32, w=48)
    out = str(tmp_path / "export.jpg")
    encode.write_image(out, np.full((3, 32, 48), 0.5, np.float32),
                       meta=meta)
    for path in (p, out, str(tmp_path / "missing.jpg")):
        assert exif.read_exif(path).__dict__ \
            == ref_exif.read_exif(path).__dict__


GPX = """<?xml version="1.0"?>
<gpx xmlns="http://www.topografix.com/GPX/1/1"><trk><trkseg>
<trkpt lat="47.0" lon="8.0"><ele>400</ele>
  <time>2024-06-01T10:00:00Z</time></trkpt>
<trkpt lat="47.1" lon="8.2"><ele>500</ele>
  <time>2024-06-01T11:00:00Z</time></trkpt>
</trkseg></trk></gpx>"""


def test_gpx_geotag(tmp_path):
    track = tmp_path / "track.gpx"
    track.write_text(GPX)
    pts = gpx.parse_gpx(str(track))
    assert [p.__dict__ for p in pts] \
        == [p.__dict__ for p in ref_gpx.parse_gpx(str(track))]
    mid = dt.datetime(2024, 6, 1, 10, 30, tzinfo=dt.timezone.utc).timestamp()
    for when in (mid, mid - 7200.0, mid + 1e5):
        assert gpx.locate(pts, when) == ref_gpx.locate(pts, when)
    lat, lon, ele = gpx.locate(pts, mid)
    assert abs(lat - 47.05) < 1e-6 and abs(lon - 8.1) < 1e-6
    assert abs(ele - 450.0) < 1e-6
    lib = Library()
    img = tmp_path / "a.npz"
    raw, meta, _ = synth_raw(h=64, w=96)
    save_raw(str(img), raw, meta)
    imgid = lib.import_image(str(img))
    lib.con.execute("UPDATE images SET datetime_taken=? WHERE id=?",
                    ("2024:06:01 10:30:00", imgid))
    assert imgid in gpx.geotag_images(lib, str(track))
    row = lib.con.execute("SELECT latitude, longitude FROM images "
                          "WHERE id=?", (imgid,)).fetchone()
    assert abs(row["latitude"] - 47.05) < 1e-6


def test_presets_cross_the_two_packages(film):
    """Presets the port saves load and auto-apply in the JAX package, with
    the same blobs (common/presets.c)."""
    lib = Library()
    ids = lib.import_film_roll(film)
    lib.con.execute("UPDATE images SET maker='FUJI', model='X-T5', "
                    "iso=1600 WHERE id=?", (ids[0],))
    presets.save_preset(lib, "punchy", "velvia", {"strength": 50.0})
    presets.save_preset(lib, "high-iso-nr", "denoiseprofile",
                        {"a": (4e-4,) * 3, "b": (1e-5,) * 3},
                        autoapply=True, iso=(800.0, 1e9))
    presets.save_preset(lib, "fuji-only", "vibrance", {"amount": 10.0},
                        autoapply=True, maker="%FUJI%")
    presets.save_preset(lib, "canon-only", "grain", {"strength": 30.0},
                        autoapply=True, maker="%Canon%")
    item = presets.load_preset(lib, "punchy", "velvia")
    from ansel_tpu_torch.core.params import decode_blob

    p = decode_blob("velvia", item.version or 1, item.params)
    assert abs(p.strength - 50.0) < 1e-6
    assert item.params == ref_presets.load_preset(lib, "punchy",
                                                  "velvia").params
    auto = presets.auto_presets(lib, ids[0])
    assert {h.op for h in auto} == {"denoiseprofile", "vibrance"}
    assert [(h.op, h.params) for h in auto] \
        == [(h.op, h.params) for h in ref_presets.auto_presets(lib, ids[0])]
    merged = presets.apply_auto_presets(
        lib, ids[0], [HistoryItem("vibrance", {"amount": 99.0})])
    assert [h.op for h in merged] == ["denoiseprofile", "vibrance"]
    assert merged[-1].params == {"amount": 99.0}


def test_undo_redo_history_and_rating(film):
    from ansel_tpu_torch.core.params import params_class
    from ansel_tpu_torch.library.undo import HistoryEditor

    lib = Library()
    imgid = lib.import_film_roll(film)[0]
    ed = HistoryEditor(lib)
    ed.write_history(imgid, [HistoryItem("exposure", {"exposure": 1.0})])
    ed.write_history(imgid, [HistoryItem("exposure", {"exposure": 2.0})])
    assert len(lib.read_history(imgid)) == 1
    ed.set_rating(imgid, 4)
    assert lib.rating(imgid) == 4
    assert ed.undo() and lib.rating(imgid) == 0
    assert ed.undo()
    cls = params_class("exposure")
    assert abs(cls.codec.decode(lib.read_history(imgid)[0].params).exposure
               - 1.0) < 1e-6
    assert ed.redo()
    assert abs(cls.codec.decode(lib.read_history(imgid)[0].params).exposure
               - 2.0) < 1e-6
    ed.stack.clear("ratings")          # the rating's redo goes
    assert not ed.redo()
    assert ed.undo() and ed.undo() and not ed.undo()
    assert lib.read_history(imgid) == []


# --- config 5's catalog: batch export, thumbnails, the CLI -------------------

def _catalog(folder, n=4):
    return configs.write_catalog5(folder, n, h=CAT_H, w=CAT_W, hx=CAT_H,
                                  wx=CAT_W)


def test_catalog5_copies_equal_the_images_bench_makes(tmp_path):
    """write_catalog5 copies images 0 and 1 for the rest of the roll:
    bench.py's seed-i images, made one by one, are those copies (the
    gradients scene ignores the seed)."""
    paths = _catalog(str(tmp_path / "film"), n=4)
    for i, path in enumerate(paths):
        raw, meta = load_raw(path)
        want_raw, want_meta = configs.catalog5_frame(i, h=CAT_H, w=CAT_W,
                                                     hx=CAT_H, wx=CAT_W)
        assert np.array_equal(raw, want_raw)
        assert (meta.width, meta.height, meta.cfa, meta.xtrans) == (
            want_meta.width, want_meta.height, want_meta.cfa,
            want_meta.xtrans)
        assert (meta.xtrans is not None) == bool(i % 2)
    assert configs.catalog5_pixels(3) == 2 * configs.BENCH_H \
        * configs.BENCH_W + configs.BENCH4_H * configs.BENCH4_W


def _share_demosaics(mp):
    """The JAX pipe with the port's RCD and Markesteijn twins."""
    def rcd_shared(x, cfa, scaler):
        def f(x, s):
            return rcd.rcd_demosaic(torch.from_numpy(np.array(x)),
                                    CFAPattern[cfa.name],
                                    torch.from_numpy(np.array(s))).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct((3,) + x.shape, jnp.float32), x, scaler)

    def mark_shared(x, pattern6):
        def f(x):
            return markesteijn.xtrans_markesteijn(
                torch.from_numpy(np.array(x)), tuple(pattern6)).numpy()
        return jax.pure_callback(
            f, jax.ShapeDtypeStruct((3,) + x.shape, jnp.float32), x)

    mp.setattr(ref_rcd, "rcd_demosaic", rcd_shared)
    mp.setattr(ref_mark, "xtrans_demosaic", mark_shared)


@pytest.fixture(scope="module")
def catalog5(tmp_path_factory):
    """Config 5's roll of 4 at 64 x 96, imported, batch-exported by the
    port on the CPU; the JAX package's export of each file."""
    root = tmp_path_factory.mktemp("catalog5")
    folder = str(root / "film")
    paths = _catalog(folder)
    lib = Library(str(root / "library.db"))
    ids = lib.import_film_roll(folder)
    written = batch_export(lib, Collection(film_folder=folder),
                           str(root / "out"), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _share_demosaics(mp)
        ref_engine._COMPILE_CACHE.clear()
        from ansel_tpu.io.rawfile import load_raw as ref_load_raw

        ref = [np.asarray(ref_export_image(*ref_load_raw(p),
                                           xmp_path=p + ".xmp"))
               for p in paths]
        ref_engine._COMPILE_CACHE.clear()
    return lib, ids, paths, written, ref, root


def test_batch_export_matches_the_jax_package(catalog5, tmp_path):
    lib, ids, paths, written, ref, _ = catalog5
    assert [os.path.basename(p) for p in written] \
        == [f"img{i:03d}.jpg" for i in range(4)]
    for path, jpg, want in zip(paths, written, ref):
        raw, meta = load_raw(path)
        assert (meta.xtrans is not None) == path.endswith(("1.npz",
                                                           "3.npz"))
        got = export_image(raw, meta, xmp_path=path + ".xmp", device="cpu")
        assert got.shape == want.shape == (3, CAT_H, CAT_W)
        assert np.abs(got - want).max() <= DISPLAY_QUANTUM
        again = str(tmp_path / os.path.basename(jpg))
        s = ExportSettings()
        encode.write_image(again, got, quality=s.quality, bpp=s.bpp,
                           icc=b"srgb", meta=meta)
        assert open(again, "rb").read() == open(jpg, "rb").read()


def test_batch_export_end_to_end(tmp_path):
    """tests/test_library.py's case on the port: a template, one sidecar."""
    roll = tmp_path / "roll_b"
    roll.mkdir()
    raw, meta, _ = synth_raw(h=96, w=128)
    for i in range(2):
        save_raw(str(roll / f"shot_{i}.npz"), raw, meta)
    write_xmp(str(roll / "shot_0.npz.xmp"), XMPDocument(
        history=[HistoryItem("exposure", {"exposure": 1.0})]))
    lib = Library()
    lib.import_film_roll(str(roll))
    out = batch_export(lib, Collection(), str(tmp_path / "out"),
                       template="$(FILE_NAME)-exported", device="cpu")
    assert len(out) == 2
    for p in out:
        assert os.path.exists(p) and p.endswith("-exported.jpg")


def test_batch_export_runs_on_the_device_worker_and_reraises(tmp_path,
                                                             monkeypatch):
    """Each render is a device job on the serialized export queue; a job's
    exception reaches the caller."""
    from ansel_tpu_torch.pipeline import export as export_mod

    folder = str(tmp_path / "film")
    _catalog(folder, n=2)
    lib = Library()
    lib.import_film_roll(folder)
    threads = []
    real = export_mod.export_image

    def spy(*a, **kw):
        threads.append((threading.current_thread().name, kw["device"]))
        return real(*a, **kw)

    monkeypatch.setattr(export_mod, "export_image", spy)
    batch_export(lib, Collection(), str(tmp_path / "out"), device="cpu")
    assert threads == [("device-worker", "cpu")] * 2
    with open(os.path.join(folder, "img001.npz"), "wb") as f:
        f.write(b"not a bundle")
    with pytest.raises(Exception) as err:
        batch_export(lib, Collection(), str(tmp_path / "out2"),
                     device="cpu")
    assert "pickle" in str(err.value) or "zip" in str(err.value).lower()


def test_batch_export_defaults_to_the_card(tmp_path, monkeypatch):
    from ansel_tpu_torch.pipeline import export as export_mod

    folder = str(tmp_path / "film")
    _catalog(folder, n=1)
    lib = Library()
    lib.import_film_roll(folder)
    devices = []
    monkeypatch.setattr(export_mod, "export_image",
                        lambda *a, **kw: devices.append(kw["device"]))
    batch_export(lib, Collection(), str(tmp_path / "out"))
    assert devices == ["cuda"]
    assert mipmap.MipmapCache(cache_dir=str(tmp_path / "m")).device == "cuda"


def test_thumbnails_equal_the_jax_package(catalog5, tmp_path):
    """MipmapCache renders the THUMBNAIL pipe at each level's long edge;
    the port's uint8 thumbnails within one level of the JAX package's."""
    _, _, paths, _, _, _ = catalog5
    cache = mipmap.MipmapCache(cache_dir=str(tmp_path / "port"),
                               device="cpu")
    ref = ref_mipmap.MipmapCache(cache_dir=str(tmp_path / "ref"))
    for path in paths[:2]:
        got = cache.get(path, 0, xmp_path=path + ".xmp")
        with pytest.MonkeyPatch.context() as mp:
            _share_demosaics(mp)
            want = ref.get(path, 0, xmp_path=path + ".xmp")
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_mipmap_cache_levels_and_lru(tmp_path):
    """tests/test_library.py's case on the port (mipmap_cache.c)."""
    roll = tmp_path / "roll_m"
    roll.mkdir()
    raw, meta, _ = synth_raw(h=256, w=384)
    p = str(roll / "shot.npz")
    save_raw(p, raw, meta)
    cache = mipmap.MipmapCache(cache_dir=str(tmp_path / "mips"),
                               mem_items=2, device="cpu")
    t0 = cache.get(p, 0)
    assert t0.dtype == np.uint8 and t0.shape[0] == 3
    assert max(t0.shape[1:]) <= 180
    assert cache.misses == 1
    cache.get(p, 0)
    assert cache.hits == 1
    cache.get(p, 1)
    cache.get(p, 2)
    cache.get(p, 0)   # evicted from memory (mem_items=2) -> disk hit
    assert cache.hits == 2
    cache.invalidate(p)
    cache.get(p, 0)
    assert cache.misses == 4


def test_initialscale_shrinks_working_size():
    import ansel_tpu_torch

    raw, meta, _ = synth_raw(h=256, w=384)
    pipe = ansel_tpu_torch.compile_pipeline(
        meta, [HistoryItem("exposure", {"exposure": 0.5})], scale=0.25,
        device="cpu")
    names = [s.name for s in pipe.pipe.stages]
    assert "initialscale" in names and "finalscale" not in names
    i = names.index("initialscale")
    assert pipe.pipe.stages[i].plan.spec_out.width == 96
    assert pipe.pipe.stages[i + 1].plan.spec_in.width == 96
    assert pipe.output_array(raw).shape[1:] == (64, 96)


def test_gallery_export(tmp_path):
    from ansel_tpu_torch.library.gallery import export_gallery

    roll = tmp_path / "roll_g"
    roll.mkdir()
    raw, meta, _ = synth_raw(h=64, w=96)
    for i in range(2):
        save_raw(str(roll / f"g_{i}.npz"), raw, meta)
    lib = Library()
    ids = lib.import_film_roll(str(roll))
    out = tmp_path / "site"
    index = export_gallery(lib, ids, str(out), title="Test roll",
                           device="cpu")
    html_text = open(index).read()
    assert "Test roll" in html_text and html_text.count("<figure>") == 2
    for i in range(2):
        assert os.path.exists(out / f"g_{i}.jpg")
        assert os.path.exists(out / "thumbs" / f"g_{i}.jpg")


def test_generate_cache(tmp_path, capsys):
    """tests/test_cli_apps.py's case on the port's CLI, on the CPU."""
    folder = tmp_path / "roll"
    folder.mkdir()
    raw, meta, _ = synth_raw(h=96, w=128)
    save_raw(str(folder / "a.npz"), raw, meta)
    save_raw(str(folder / "b.npz"), raw, meta)
    libpath = tmp_path / "library.db"
    lib = Library(str(libpath))
    lib.import_film_roll(str(folder))
    lib.close()
    cache = tmp_path / "cache"
    rc = cli.main(["--generate-cache", "--library", str(libpath),
                   "--min-mip", "0", "--max-mip", "1",
                   "--cache-dir", str(cache), "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "generated 4 thumbnails" in out
    assert len([f for f in os.listdir(cache) if f.endswith(".npz")]) == 4
    # a second run reads the disk store
    rc = cli.main(["--generate-cache", "--library", str(libpath),
                   "--max-mip", "1", "--cache-dir", str(cache),
                   "--device", "cpu", "--max-imgid", "1"])
    assert rc == 0
    assert "(hits 2, misses 0)" in capsys.readouterr().out


_LENS_XML = """<lensdatabase>
 <camera><maker>Canon</maker><model>Canon EOS 40D</model>
  <mount>Canon EF</mount><cropfactor>1.6</cropfactor></camera>
 <lens><maker>Canon</maker>
  <model>Canon EF 100mm f/2.8L Macro IS USM</model>
  <mount>Canon EF</mount><cropfactor>1.0</cropfactor>
  <calibration>
   <distortion model="ptlens" focal="100" a="0.03" b="-0.09" c="0.05"/>
  </calibration></lens>
</lensdatabase>"""


@pytest.mark.parametrize("form", ["checkout", "tarball"])
def test_ingest_lensfun(tmp_path, capsys, form):
    """`--ingest-lensfun` on the port's CLI (host only: XML read and
    copied) against the JAX package's `ingest_db` of the same source;
    the lens op then resolves the ingested calibration."""
    src = tmp_path / "checkout" / "data" / "db"
    src.mkdir(parents=True)
    (src / "slr-canon.xml").write_text(_LENS_XML)
    (src / "broken.xml").write_text("<lensdatabase><unclosed>")
    source = str(tmp_path / "checkout")
    if form == "tarball":
        source = str(tmp_path / "lensfun.tar.gz")
        with tarfile.open(source, "w:gz") as tf:
            tf.add(str(tmp_path / "checkout"), arcname="lensfun-0.3")
    base = lensfun.resolve("Canon EOS 40D",
                           "Canon EF 100mm f/2.8L Macro IS USM",
                           focal=100.0, aperture=5.6)
    try:
        assert cli.main(["--ingest-lensfun", source,
                         str(tmp_path / "port")]) == 0
        assert "ingested lensfun db: 1 cameras, 1 lenses" \
            in capsys.readouterr().out
        assert ref_lensfun.ingest_db(source, str(tmp_path / "ref")) == (1, 1)
        assert sorted(os.listdir(tmp_path / "port")) \
            == sorted(os.listdir(tmp_path / "ref")) == ["slr-canon.xml"]
        assert conf.get("lensfun/dbpath") == str(tmp_path / "port")
        new = lensfun.resolve("Canon EOS 40D",
                              "Canon EF 100mm f/2.8L Macro IS USM",
                              focal=100.0, aperture=5.6)
        assert new.dist == (0.03, -0.09, 0.05) != tuple(base.dist)
    finally:
        conf.set("lensfun/dbpath", "")
        ref_conf.set("lensfun/dbpath", "")
        lensfun.load_db.cache_clear()
        ref_lensfun.load_db.cache_clear()


def test_ingest_lensfun_usage(capsys):
    assert cli.main(["--ingest-lensfun"]) == 2
    assert "usage" in capsys.readouterr().err


def test_r17_the_srgb_profile_is_built_once_a_process():
    """R17: LCMS stamps a profile with the second it was built, and the
    JAX package builds the sRGB profile it embeds for each file, so the
    same image exported twice a second apart gives other bytes.  The port
    builds it once a process: batch-exported JPEGs equal `write_image` of
    the same array byte for byte."""
    import time

    from ansel_tpu.io import encode as ref_encode

    pytest.importorskip("PIL")
    first = ref_encode.srgb_icc_bytes()
    port_first = encode.srgb_icc_bytes()
    time.sleep(1.1)
    assert ref_encode.srgb_icc_bytes() != first     # the clock's second
    assert encode.srgb_icc_bytes() == port_first
    assert encode.srgb_icc_bytes()[36:] == first[36:]
