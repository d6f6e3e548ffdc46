"""The port's image server (`diffusers_tpu_torch.serving.server`) on the CPU,
against the JAX server (`examples/server/server.py`), and the port's PNG
codec against PIL.

Both servers serve the tiny SD3 pipeline of tests/test_torch_pipeline_sd3.py
(the same weights) and answer the same requests: the greeting, a generation
of two images, a fetch of one, a request without a prompt (422) and an
unknown route (404); the status codes and the JSON shapes must be the same.
Then the port's server alone: three requests of one shape, the second and
third sent while the worker holds the first, must run as two pipeline calls
(batch 1, then the two coalesced into batch 2); the first image equals a
direct pipeline call from the same seed bit for bit. Without a pipeline,
`serve()` loads `MODEL_PATH` with the pipeline-level `from_pretrained`: the
default hub id raises `EnvironmentError`; a tiny SD3 directory saved with
real tokenizers reaches the loader, which refuses the card's default device
here; loaded on the CPU, the same directory serves a request equal to a
direct call.
"""

import importlib.util
import io
import json
import logging
import pathlib
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import clip_tokenizer, t5_tokenizer
from diffusers_tpu_torch.serving import server
from diffusers_tpu_torch.utils.png import decode_png, encode_png
from test_torch_pipeline_sd3 import JaxSD3Pipeline, StableDiffusion3Pipeline, build
from test_torch_jit_reference import jax_reference_speedups  # noqa: F401 (autouse)

torch.set_num_threads(1)

SIZE = "8x8"  # the tiny VAE keeps the 8 x 8 latents
HANDLER = dict(default_size=SIZE, default_steps=2, default_guidance=5.0)


def _load_jax_server():
    path = pathlib.Path(__file__).parents[1] / "examples" / "server" / "server.py"
    spec = importlib.util.spec_from_file_location("tpu_server_example_for_port", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclass annotation resolution
    spec.loader.exec_module(mod)
    return mod


def _request(port, path, payload=None):
    """(status, body bytes) of a GET (no payload) or a JSON POST."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _shape(obj):
    """The JSON structure: keys and list lengths, leaves replaced by their type."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj]
    return type(obj).__name__


def _conversation(httpd):
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status_root, root = _request(port, "/")
        status_gen, gen = _request(port, "/v1/images/generations", {"prompt": "a tiny fox", "n": 2})
        gen = json.loads(gen)
        fname = gen["data"][0]["url"].rsplit("/", 1)[-1]
        status_img, png = _request(port, f"/images/{fname}")
        status_missing, missing = _request(port, "/v1/images/generations", {})
        status_route, route = _request(port, "/v2/other", {"prompt": "x"})
        status_nofile, _ = _request(port, "/images/none.png")
    finally:
        httpd.shutdown()
        httpd.worker.stop()
    return {"codes": (status_root, status_gen, status_img, status_missing, status_route, status_nofile),
            "json": [_shape(json.loads(b)) for b in (root, json.dumps(gen).encode(), missing, route)], "png": png}


def test_server_answers_the_jax_servers_api(tmp_path, monkeypatch):
    jpipe, tpipe = build(t5=False, jcls=JaxSD3Pipeline, tcls=StableDiffusion3Pipeline)
    jax_server = _load_jax_server()
    monkeypatch.setattr(jax_server, "IMAGE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(server, "IMAGE_DIR", str(tmp_path / "port"))
    ref = _conversation(jax_server.serve(pipeline=jpipe, host="127.0.0.1", port=0, **HANDLER))
    out = _conversation(server.serve(pipeline=tpipe, host="127.0.0.1", port=0, seed=0, **HANDLER))
    assert out["codes"] == ref["codes"] == (200, 200, 200, 422, 404, 404)
    assert out["json"] == ref["json"]
    assert out["json"][1] == {"data": [{"url": "str"}, {"url": "str"}]}
    image = decode_png(out["png"])
    assert image.shape == (8, 8, 3) and image.dtype == np.uint8
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(out["png"]))), image)
    assert np.asarray(Image.open(io.BytesIO(ref["png"]))).shape == image.shape


def test_server_coalesces_same_shape_requests(tmp_path, monkeypatch):
    _, pipe = build(t5=False, jcls=JaxSD3Pipeline, tcls=StableDiffusion3Pipeline)
    monkeypatch.setattr(server, "IMAGE_DIR", str(tmp_path))
    httpd = server.serve(pipeline=pipe, host="127.0.0.1", port=0, seed=7, **HANDLER)
    worker, port = httpd.worker, httpd.server_address[1]

    # the worker's first pipeline call waits until two more jobs are queued
    held = threading.Event()

    def hold_first(mod, args):
        handle.remove()
        held.set()
        while worker.jobs.qsize() < 2:
            threading.Event().wait(0.01)

    handle = pipe.transformer.register_forward_pre_hook(hold_first)
    records = []
    log_handler = logging.Handler()
    log_handler.emit = lambda record: records.append(record.getMessage())
    server.logger.addHandler(log_handler)
    server.logger.setLevel(logging.INFO)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    results = {}

    def post(i, prompt):
        results[i] = _request(port, "/v1/images/generations", {"prompt": prompt})

    try:
        first = threading.Thread(target=post, args=(0, "a red kite"))
        first.start()
        assert held.wait(timeout=120)
        others = [threading.Thread(target=post, args=(i, p)) for i, p in ((1, "a blue kite"), (2, "a green kite"))]
        for t in others:
            t.start()
        for t in (first, *others):
            t.join(timeout=120)
    finally:
        server.logger.removeHandler(log_handler)
        httpd.shutdown()
        worker.stop()
    batches = [int(m.split()[0].split("=")[1]) for m in records if m.startswith("batch=")]
    assert batches == [1, 2], records
    assert all(results[i][0] == 200 for i in range(3))
    served = []
    for i in range(3):
        fname = json.loads(results[i][1])["data"][0]["url"].rsplit("/", 1)[-1]
        served.append(decode_png((tmp_path / fname).read_bytes()))
    # the first request drew the generator's first latents: a direct call from the same seed
    direct = pipe("a red kite", height=8, width=8, num_inference_steps=2, guidance_scale=5.0,
                  generator=torch.Generator().manual_seed(7), output_type="np").images[0]
    np.testing.assert_array_equal(served[0], server.to_uint8(direct))
    assert not np.array_equal(served[1], served[2])


def test_serve_without_a_pipeline_raises(monkeypatch):
    """The default load is the pipeline-level `from_pretrained` of MODEL_PATH,
    whose default is a hub id: loading from the hub is not ported, so serving
    raises instead of serving something else."""
    monkeypatch.delenv("MODEL_PATH", raising=False)
    with pytest.raises(EnvironmentError, match="stabilityai/stable-diffusion-3.5-medium.*hub"):
        server.serve(host="127.0.0.1", port=0)


def test_serve_loads_model_path(tmp_path, monkeypatch):
    _, pipe = build(t5=True, jcls=JaxSD3Pipeline, tcls=StableDiffusion3Pipeline)
    pipe.register_modules(tokenizer=clip_tokenizer(tmp_path / "clip"), tokenizer_2=clip_tokenizer(tmp_path / "clip"),
                          tokenizer_3=t5_tokenizer(tmp_path / "t5"))
    pipe.save_pretrained(tmp_path / "sd3")
    monkeypatch.setenv("MODEL_PATH", str(tmp_path / "sd3"))
    with pytest.raises(RuntimeError, match="StableDiffusion3Pipeline.from_pretrained: no CUDA device"):
        server.serve(host="127.0.0.1", port=0)  # the server loads onto the card

    loaded = StableDiffusion3Pipeline.from_pretrained(tmp_path / "sd3", device="cpu")
    monkeypatch.setattr(server, "IMAGE_DIR", str(tmp_path / "images"))
    httpd = server.serve(pipeline=loaded, host="127.0.0.1", port=0, seed=3, **HANDLER)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = _request(httpd.server_address[1], "/v1/images/generations", {"prompt": "a red kite"})
    finally:
        httpd.shutdown()
        httpd.worker.stop()
    assert status == 200
    served = decode_png((tmp_path / "images" / json.loads(body)["data"][0]["url"].rsplit("/", 1)[-1]).read_bytes())
    direct = pipe("a red kite", height=8, width=8, num_inference_steps=2, guidance_scale=5.0,
                  generator=torch.Generator().manual_seed(3), output_type="np").images[0]
    np.testing.assert_array_equal(served, server.to_uint8(direct))


def _filters(png: bytes, row_bytes: int):
    """The row filter types of a PNG's single-IDAT image data."""
    start = png.index(b"IDAT") + 4
    raw = zlib.decompressobj().decompress(png[start:])
    return {raw[i] for i in range(0, len(raw), row_bytes + 1)}


@pytest.mark.parametrize("shape", [(7, 13, 3), (5, 9, 4), (6, 11)])
def test_png_round_trip_against_pil(shape):
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, shape).astype(np.uint8)
    # the port's encoder, read by PIL
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(image)))), image)
    # PIL's encoder (adaptive row filters on a smooth image), read by the port
    smooth = np.broadcast_to((np.indices(shape[:2]).sum(0) * 9 % 256).astype(np.uint8)[..., None],
                             shape[:2] + (shape[2] if len(shape) == 3 else 1,)).reshape(shape)
    for picture in (image, np.ascontiguousarray(smooth)):
        buf = io.BytesIO()
        Image.fromarray(picture).save(buf, format="PNG", optimize=True)
        np.testing.assert_array_equal(decode_png(buf.getvalue()).reshape(shape), picture)
    row_bytes = shape[1] * (shape[2] if len(shape) == 3 else 1)
    assert _filters(buf.getvalue(), row_bytes) - {0}, "PIL wrote no filtered row: the reader's filters went untested"


def test_png_refuses_what_it_does_not_read():
    png = bytearray(encode_png(np.zeros((2, 3, 3), np.uint8)))
    png[-5] ^= 1  # the IEND chunk's CRC
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(png))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 3, 3), np.float32))
