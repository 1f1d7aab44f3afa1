"""Dataset file helpers (port of `attentiondm_tpu/data/download.py`).

`check_md5` is JAX's.  Nothing is downloaded: `download_url` and
`download_file_from_google_drive` return the file when it is already at
`<root>/<filename>` and verified, and otherwise raise FileNotFoundError
naming the path to place it at and its md5 (JAX's fetch over the network
is a departure of the port; every reader works from local files).
"""
from __future__ import annotations

import hashlib
import os
import urllib.parse


def check_md5(path: str, md5: str) -> bool:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest() == md5


def _present(path: str, md5: str | None, source: str) -> str:
    if os.path.exists(path):
        if md5 is None or check_md5(path, md5):
            return path
        why = f"{path} fails md5 verification"
    else:
        why = f"{path} is not there"
    raise FileNotFoundError(f"{why}; nothing is downloaded ({source}): place the file at {path}"
                            + (f" (md5 {md5})" if md5 else ""))


def download_url(url: str, root: str, filename: str | None = None, md5: str | None = None) -> str:
    """`root/filename` (default: the URL's base name) when present and verified."""
    filename = filename or os.path.basename(urllib.parse.urlparse(url).path)
    return _present(os.path.join(root, filename), md5, url)


def download_file_from_google_drive(file_id: str, root: str, filename: str, md5: str | None = None) -> str:
    """`root/filename` when present and verified (the Google Drive file `file_id`)."""
    return _present(os.path.join(root, filename), md5, f"Google Drive file {file_id}")
