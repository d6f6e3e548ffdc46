"""Text-to-image HTTP server of the port, on one NVIDIA card.

Port of `examples/server/server.py`: a stdlib `http.server` with the same
API, defaults and shape.

  * ONE worker thread owns the pipeline, and with it the card: requests are
    funnelled through a queue.
  * Requests with the same (height, width, steps, guidance) coalesce into a
    MICRO-BATCH of up to `MAX_MICROBATCH` jobs (environment, default 4):
    their prompts stack on the batch axis of one pipeline call.
  * Randomness: one `torch.Generator` on the pipeline's device, seeded from
    `seed` (from `os.urandom` when None), which each batch's pipeline call
    draws from once (its initial latents), where JAX splits a key a batch.
  * Images are written as PNG by the port's own encoder
    (`diffusers_tpu_torch.utils.png`; the card's machine has no PIL) from
    the pipeline's "np" output, rounded to uint8 as the "pil" output is.

API (OpenAI images shape):
    POST /v1/images/generations   {"prompt": "...", "n": 1, "size": "1024x1024",
                                   "steps": 28, "guidance_scale": 7.0}
        -> {"data": [{"url": "http://host/images/draw<id>.png"}]}
        (422 without a prompt, 404 on another route)
    GET  /images/<file>           the PNG results
    GET  /                        greeting

Run: `serve(pipeline=pipe, host=..., port=...)` returns the HTTP server
(`serve_forever()` it; `httpd.worker.stop()` afterwards). Without a pipeline
it loads `StableDiffusion3Pipeline.from_pretrained(MODEL_PATH,
dtype=torch.bfloat16)` onto the card, as the JAX server does: MODEL_PATH
(environment) is a local pipeline directory or `.dduf` file. Its default,
the hub id stabilityai/stable-diffusion-3.5-medium, raises the loader's
`EnvironmentError` (hub loading is not ported); so does
`python -m diffusers_tpu_torch.serving.server` without MODEL_PATH.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from ..utils.png import encode_png

logger = logging.getLogger("diffusers_tpu_torch.server")

IMAGE_DIR = os.path.join(tempfile.gettempdir(), "images")
SERVICE_URL = os.getenv("SERVICE_URL", "http://localhost:8000")
MAX_MICROBATCH = int(os.getenv("MAX_MICROBATCH", "4"))


@dataclass
class _Job:
    prompt: str
    height: int
    width: int
    steps: int
    guidance: float
    n: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[str]] = None
    error: Optional[str] = None

    @property
    def batch_key(self):
        return (self.height, self.width, self.steps, self.guidance)


class Worker:
    """Single thread that owns the pipeline (and therefore the card)."""

    def __init__(self, pipeline=None, seed: Optional[int] = None):
        self.pipeline = pipeline
        self.seed = int.from_bytes(os.urandom(4), "little") if seed is None else seed
        self.jobs: "queue.Queue[Optional[_Job]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self):
        if self.pipeline is None:
            self.pipeline = self._load_pipeline()
        os.makedirs(IMAGE_DIR, exist_ok=True)
        self.generator = torch.Generator(device=self.pipeline.device).manual_seed(self.seed)
        self._thread = threading.Thread(target=self._run, name="card-worker", daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self.jobs.put(None)  # wake the worker
        if self._thread is not None:
            self._thread.join(timeout=10)

    @staticmethod
    def _load_pipeline():
        from .. import StableDiffusion3Pipeline

        model_path = os.getenv("MODEL_PATH", "stabilityai/stable-diffusion-3.5-medium")
        logger.info("loading %s onto the card", model_path)
        return StableDiffusion3Pipeline.from_pretrained(model_path, dtype=torch.bfloat16)

    def submit(self, job: _Job) -> _Job:
        self.jobs.put(job)
        job.done.wait()
        return job

    def _run(self):
        while not self._stop.is_set():
            job = self.jobs.get()
            if job is None:
                continue
            # coalesce same-shape jobs into one micro-batch (one pipeline call)
            batch = [job]
            try:
                while len(batch) < MAX_MICROBATCH:
                    peek = self.jobs.get_nowait()
                    if peek is None:
                        break
                    if peek.batch_key == job.batch_key:
                        batch.append(peek)
                    else:
                        self.jobs.put(peek)
                        break
            except queue.Empty:
                pass
            prompts = []
            for j in batch:
                prompts.extend([j.prompt] * j.n)
            t0 = time.monotonic()
            try:
                out = self.pipeline(
                    prompts, height=job.height, width=job.width, num_inference_steps=job.steps,
                    guidance_scale=job.guidance, generator=self.generator, output_type="np",
                )
                urls = [_save_image(to_uint8(im)) for im in out.images]
                logger.info("batch=%d %dx%d steps=%d in %.2fs", len(prompts), job.width, job.height, job.steps,
                            time.monotonic() - t0)
                i = 0
                for j in batch:
                    j.result = urls[i: i + j.n]
                    i += j.n
            except Exception as exc:  # surface per-job
                logger.exception("generation failed")
                for j in batch:
                    j.error = str(exc)
            finally:
                for j in batch:
                    j.done.set()


def to_uint8(image: np.ndarray) -> np.ndarray:
    """float [H, W, C] in [0, 1] -> uint8, rounded (the "pil" output's rule)."""
    return np.round(np.clip(np.asarray(image, dtype=np.float32), 0.0, 1.0) * 255.0).astype(np.uint8)


def _save_image(image: np.ndarray) -> str:
    filename = "draw" + str(uuid.uuid4()).split("-")[0] + ".png"
    with open(os.path.join(IMAGE_DIR, filename), "wb") as f:
        f.write(encode_png(image))
    return f"{SERVICE_URL}/images/{filename}"


def make_handler(worker: Worker, default_size: str = "1024x1024", default_steps: int = 28,
                 default_guidance: float = 7.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/images/"):
                path = os.path.join(IMAGE_DIR, os.path.basename(self.path))
                if not os.path.isfile(path):
                    return self._json(404, {"error": "not found"})
                with open(path, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self._json(200, {"message": "Welcome to diffusers-tpu-torch! POST /v1/images/generations"})

        def do_OPTIONS(self):
            self._json(200, {})

        def do_POST(self):
            if self.path.rstrip("/") == "":
                return self._json(200, {"message": "Welcome to diffusers-tpu-torch!"})
            if self.path != "/v1/images/generations":
                return self._json(404, {"error": "unknown route"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                prompt = payload.get("prompt")
                if not prompt:
                    return self._json(422, {"error": "`prompt` is required"})
                size = payload.get("size") or default_size
                w, h = (int(v) for v in size.lower().split("x"))
                job = _Job(
                    prompt=prompt, height=h, width=w,
                    steps=int(payload.get("steps", default_steps)),
                    guidance=float(payload.get("guidance_scale", default_guidance)),
                    n=int(payload.get("n") or 1),
                )
                worker.submit(job)
                if job.error is not None:
                    return self._json(500, {"error": job.error})
                self._json(200, {"data": [{"url": u} for u in job.result]})
            except Exception as exc:
                self._json(500, {"error": str(exc)})

    return Handler


def serve(pipeline=None, host: str = "0.0.0.0", port: int = 8000, seed: Optional[int] = None, **handler_kwargs):
    """Start the worker and return the HTTP server (not yet serving). Pass
    `pipeline` to skip the default model load; `seed` seeds the worker's
    generator (random when None)."""
    worker = Worker(pipeline=pipeline, seed=seed)
    worker.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(worker, **handler_kwargs))
    httpd.worker = worker
    return httpd


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    server = serve(port=int(os.getenv("PORT", "8000")))
    logger.info("serving on %s", SERVICE_URL)
    try:
        server.serve_forever()
    finally:
        server.worker.stop()
