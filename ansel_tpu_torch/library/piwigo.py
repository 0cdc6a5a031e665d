"""Piwigo web-album storage plugin (`ansel_tpu/library/piwigo.py`,
copied; the export renders on the port).

Reference: `ansel/src/imageio/storage/piwigo.c` — the ws.php
JSON API client: `pwg.session.login` + `pwg.session.getStatus` (pwg_token,
piwigo.c:394-431), `pwg.categories.getList` / `pwg.categories.add`
(piwigo.c:629, 695-726), `pwg.images.addSimple` multipart upload
(piwigo.c:728-760) and `pwg.images.uploadCompleted` (piwigo.c:956).

Pure-stdlib HTTP (urllib + http.cookiejar) — no curl dependency.  The
server URL normalization mirrors piwigo.c:401-406: a bare "piwigo.com"
routes to https://<user>.piwigo.com, an http(s) prefix is kept verbatim,
anything else gets https:// prepended.
"""

from __future__ import annotations

import http.cookiejar
import json
import mimetypes
import os
import urllib.parse
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..core import log as _log


def _info(msg, *a):
    _log.log("storage", msg % a if a else msg)


class PiwigoError(RuntimeError):
    pass


def _ws_url(server: str, username: str) -> str:
    if server == "piwigo.com":
        return f"https://{username}.piwigo.com/ws.php?format=json"
    if server.startswith("http"):
        return f"{server}/ws.php?format=json"
    return f"https://{server}/ws.php?format=json"


@dataclass
class PiwigoAlbum:
    id: int
    name: str
    # "/"-joined path of translated names, like piwigo.c's combobox label
    label: str = ""


@dataclass
class PiwigoClient:
    """Session-scoped API context (piwigo.c `_piwigo_api_context_t`)."""

    server: str
    username: str
    password: str = ""
    url: str = ""
    pwg_token: str = ""
    authenticated: bool = False
    _opener: object = field(default=None, repr=False)

    def __post_init__(self):
        self.url = self.url or _ws_url(self.server, self.username)
        jar = http.cookiejar.CookieJar()
        self._opener = urllib.request.build_opener(
            urllib.request.HTTPCookieProcessor(jar))

    # -- transport ------------------------------------------------------
    def _post(self, args: Dict[str, str],
              filepath: Optional[str] = None) -> dict:
        """One ws.php POST; urlencoded, or multipart when a file rides
        along (piwigo.c `_piwigo_api_post_internal`).  -> parsed "result"
        member; raises PiwigoError on stat=="fail"."""
        if filepath is None:
            data = urllib.parse.urlencode(args).encode()
            req = urllib.request.Request(self.url, data=data)
        else:
            boundary = uuid.uuid4().hex
            parts = []
            for k, v in args.items():
                parts.append(
                    (f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="{k}"\r\n\r\n{v}\r\n').encode())
            ctype = (mimetypes.guess_type(filepath)[0]
                     or "application/octet-stream")
            with open(filepath, "rb") as f:
                payload = f.read()
            parts.append(
                (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="image"; filename='
                 f'"{os.path.basename(filepath)}"\r\n'
                 f"Content-Type: {ctype}\r\n\r\n").encode()
                + payload + b"\r\n")
            parts.append(f"--{boundary}--\r\n".encode())
            body = b"".join(parts)
            req = urllib.request.Request(self.url, data=body, headers={
                "Content-Type":
                    f"multipart/form-data; boundary={boundary}"})
        with self._opener.open(req) as resp:
            doc = json.loads(resp.read().decode("utf-8", "replace"))
        if not isinstance(doc, dict) or doc.get("stat") == "fail":
            raise PiwigoError(
                f"piwigo {args.get('method')}: "
                f"{doc.get('message', 'bad response') if isinstance(doc, dict) else doc}")
        return doc.get("result", {})

    # -- api ------------------------------------------------------------
    def login(self) -> None:
        self._post({"method": "pwg.session.login",
                    "username": self.username,
                    "password": self.password})
        status = self._post({"method": "pwg.session.getStatus"})
        self.pwg_token = str(status.get("pwg_token", ""))
        self.authenticated = True
        _info("authenticated against %s", self.server)

    def logout(self) -> None:
        if self.authenticated:
            self._post({"method": "pwg.session.logout"})
            self.authenticated = False

    def albums(self) -> List[PiwigoAlbum]:
        """Full recursive album list (piwigo.c `_piwigo_api_fetch_albums`)."""
        result = self._post({"method": "pwg.categories.getList",
                             "cat_id": "0", "recursive": "true"})
        out: List[PiwigoAlbum] = []
        for cat in result.get("categories", []):
            out.append(PiwigoAlbum(
                id=int(cat["id"]), name=str(cat.get("name", "")),
                label=str(cat.get("fullname", cat.get("name", "")))))
        return out

    def create_album(self, name: str, parent_id: int = 0,
                     private: bool = False) -> int:
        args = {"method": "pwg.categories.add", "name": name,
                "status": "private" if private else "public"}
        if parent_id:
            args["parent"] = str(parent_id)
        result = self._post(args)
        return int(result["id"])

    def upload(self, filepath: str, album_id: int, level: int = 0,
               name: str = "", author: str = "", description: str = "",
               tags: str = "") -> int:
        """pwg.images.addSimple multipart upload; -> image_id."""
        args = {"method": "pwg.images.addSimple",
                "category": str(album_id), "level": str(level)}
        if name:
            args["name"] = name
        if author:
            args["author"] = author
        if description:
            args["comment"] = description
        if tags:
            args["tags"] = tags
        result = self._post(args, filepath=filepath)
        image_id = int(result.get("image_id", 0))
        if image_id and self.pwg_token:
            # finalize (piwigo.c:950-963) so the gallery regenerates
            # derivative sizes for the fresh upload
            self._post({"method": "pwg.images.uploadCompleted",
                        "image_id": str(image_id),
                        "pwg_token": self.pwg_token,
                        "category_id": str(album_id)})
        return image_id


def store_piwigo(lib, imgids: Sequence[int], client: PiwigoClient,
                 album: str, parent_album_id: int = 0,
                 settings=None, private: bool = False,
                 author: str = "", tags: str = "",
                 tmp_dir: Optional[str] = None,
                 device="cuda") -> List[int]:
    """Export each image and upload it — the storage `store()` entry
    (piwigo.c:966-1104: export to a temp jpg, then addSimple).
    `album` is matched case-sensitively against existing album names;
    missing albums are created.  The render runs on `device`.  ->
    uploaded piwigo image ids."""
    import tempfile

    from ..io.rawfile import load_raw
    from ..pipeline.export import ExportSettings, export_image

    settings = settings or ExportSettings(format="jpg")
    if not client.authenticated:
        client.login()
    album_id = 0
    for a in client.albums():
        if a.name == album:
            album_id = a.id
            break
    if not album_id:
        album_id = client.create_album(album, parent_id=parent_album_id,
                                       private=private)
    uploaded: List[int] = []
    tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="ansel_piwigo_")
    for imgid in imgids:
        src = lib.image_path(imgid)
        xmp = lib.xmp_path(imgid)
        raw, meta = load_raw(src)
        base = os.path.splitext(os.path.basename(src))[0]
        out_path = os.path.join(tmp_dir, f"{base}.{settings.format}")
        export_image(raw, meta,
                     xmp_path=xmp if os.path.exists(xmp) else None,
                     output_path=out_path, settings=settings, device=device)
        image_id = client.upload(
            out_path, album_id, level=4 if private else 0,
            name=base, author=author, tags=tags)
        uploaded.append(image_id)
        _info("uploaded %s -> piwigo image %d", base, image_id)
    return uploaded
