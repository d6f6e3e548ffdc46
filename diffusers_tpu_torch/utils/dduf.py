"""DDUF single-archive pipeline format.

The port's own copy of `diffusers_tpu/utils/dduf.py` (`:22-50`): a DDUF file
is an uncompressed (STORE-only) zip of a saved pipeline folder with
`model_index.json` at its root. `save_dduf` packs a folder that
`DiffusionPipeline.save_pretrained` wrote; `extract_dduf` unpacks one for
`DiffusionPipeline.from_pretrained`, which takes a `.dduf` path directly.
"""

from __future__ import annotations

import os
import tempfile
import zipfile

from . import logging

logger = logging.get_logger(__name__)


def save_dduf(pipeline_dir: str, output_path: str) -> str:
    """Pack a saved pipeline folder into a `.dduf` archive (zip, STORE-only)."""
    if not os.path.exists(os.path.join(pipeline_dir, "model_index.json")):
        raise ValueError(f"{pipeline_dir} is not a saved pipeline (no model_index.json)")
    if not str(output_path).endswith(".dduf"):
        raise ValueError("DDUF archives must use the .dduf extension")
    with zipfile.ZipFile(output_path, "w", compression=zipfile.ZIP_STORED) as z:
        for root, _, files in os.walk(pipeline_dir):
            for fname in sorted(files):
                full = os.path.join(root, fname)
                z.write(full, arcname=os.path.relpath(full, pipeline_dir))
    logger.info("wrote DDUF archive %s", output_path)
    return str(output_path)


def extract_dduf(dduf_path: str, output_dir: str | None = None) -> str:
    """Unpack a `.dduf` archive; returns the extracted pipeline directory."""
    if output_dir is None:
        output_dir = tempfile.mkdtemp(prefix="dduf_")
    with zipfile.ZipFile(dduf_path) as z:
        names = z.namelist()
        if "model_index.json" not in names:
            raise ValueError(f"{dduf_path} is not a DDUF pipeline archive (no model_index.json)")
        for n in names:  # refuse path traversal
            if n.startswith("/") or ".." in n.split("/"):
                raise ValueError(f"unsafe entry {n!r} in DDUF archive")
        z.extractall(output_dir)
    return output_dir
