#!/usr/bin/env python
"""Tokenizer serving daemon of the port.

The counterpart of the repository's root ``serve.py``: a dependency-free
HTTP service over the engine's ``quant`` / ``dequant`` with request
micro-batching.  Concurrent requests of one op that land within
``batch_window_ms`` are fused into one device batch, padded to a
power-of-two bucket by repeating its last item.

    python -m vqvae_from_gaussian_vae_tpu_torch.serve \\
        --base configs/sd3unet_gq_0.25.yaml --port 8500 --batch_window_ms 5 \\
        model.params.encoder_config.params.dtype=bfloat16 [--ckpt model.ckpt] [--device cpu]

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.  Further
``key=value`` arguments are dotlist overrides of the config (above: the bf16
backbones; the decoder's params interpolate the encoder's).

API (JSON unless noted):
  GET  /healthz            -> {"status": "ok", "model": ..., "devices": N}
  POST /tokenize           body: raw PNG/JPEG bytes
                           -> {"indices": [...], "shape": [h, w, ng]}
  POST /detokenize         body: {"indices": [...], "shape": [h, w, ng]}
                           -> raw PNG bytes of the reconstruction
  POST /reconstruct        body: raw PNG/JPEG bytes -> raw PNG bytes
"""

from __future__ import annotations

import argparse
import io
import json
import os
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class TokenizerService:
    """Micro-batching front of the engine's ``quant`` and ``dequant``.

    One pending list per op kind; a worker thread drains the deepest
    backlog, waits up to the batch window for it to fill, pads the batch to
    its bucket and runs it on the engine's device.  The worker binds that
    device before its first launch.  ``drained[kind]`` counts the batches
    of each kind that went to the engine and the requests they held.
    """

    def __init__(self, engine, image_size: int, max_batch: int = 8,
                 batch_window_ms: float = 5.0):
        self.engine = engine
        self.image_size = image_size
        self.max_batch = max_batch
        self.window = batch_window_ms / 1e3
        self._cv = threading.Condition()
        self._pending = {"tokenize": [], "detokenize": []}
        self.drained = {k: {"batches": 0, "requests": 0} for k in self._pending}
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -------------------------------------------------------------- public

    def tokenize(self, img: np.ndarray) -> np.ndarray:
        return self._submit(("tokenize", img))

    def detokenize(self, indices: np.ndarray) -> np.ndarray:
        return self._submit(("detokenize", indices))

    def worker_alive(self) -> bool:
        return self._worker.is_alive()

    # ------------------------------------------------------------ batching

    def _submit(self, item):
        done = threading.Event()
        box = {}
        with self._cv:
            self._pending[item[0]].append((item, box, done))
            self._cv.notify()
        done.wait()
        if "error" in box:
            raise RuntimeError(box["error"])
        return box["result"]

    def _drain(self):
        """Pick the op kind with the deepest backlog, wait up to the batch
        window for it to fill, then take up to max_batch requests."""
        with self._cv:
            while not any(self._pending.values()):
                self._cv.wait()
            kind = max(self._pending, key=lambda k: len(self._pending[k]))
        deadline = time.perf_counter() + self.window
        while True:
            with self._cv:
                if len(self._pending[kind]) >= self.max_batch:
                    break
            if time.perf_counter() >= deadline:
                break
            time.sleep(0.0005)
        with self._cv:
            batch = self._pending[kind][: self.max_batch]
            del self._pending[kind][: len(batch)]
        return kind, batch

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Next power-of-two batch bucket: drained batches are padded to a
        bucket so the device sees log2(max_batch) + 1 batch shapes."""
        b = 1
        while b < n:
            b *= 2
        return min(b, max(cap, n))

    def _run(self):
        device = next(self.engine.module.parameters()).device  # with its index
        if device.type == "cuda":
            torch.cuda.set_device(device)  # the CUDA runtime's current device is a thread's
        while True:
            kind, batch = self._drain()
            if not batch:  # raced with another drain pass
                continue
            try:
                arrays = np.stack([item[0][1] for item in batch])
                n = arrays.shape[0]
                bucket = self._bucket(n, self.max_batch)
                if bucket != n:
                    fill = np.repeat(arrays[-1:], bucket - n, axis=0)
                    arrays = np.concatenate([arrays, fill], axis=0)
                x = torch.from_numpy(arrays).to(device)
                self.drained[kind]["batches"] += 1
                self.drained[kind]["requests"] += n
                if kind == "tokenize":
                    _, out = self.engine.quant(x)
                else:
                    out = self.engine.dequant(x)
                out = out.float().cpu().numpy() if out.is_floating_point() else out.cpu().numpy()
                for i, (_, box, done) in enumerate(batch):
                    box["result"] = out[i]
                    done.set()
            except Exception as e:  # a boundary that must keep serving: each request gets a 500
                traceback.print_exc()
                for _, box, done in batch:
                    box["error"] = repr(e)
                    done.set()


def make_handler(service: TokenizerService, model_name: str):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _png(self, arr: np.ndarray):
            u8 = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(u8).save(buf, format="PNG")
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_image(self) -> np.ndarray:
            n = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(n)
            img = Image.open(io.BytesIO(data)).convert("RGB")
            s = service.image_size
            w, h = img.size
            scale = s / min(w, h)
            img = img.resize((max(s, round(w * scale)), max(s, round(h * scale))),
                             Image.BILINEAR)
            left = (img.size[0] - s) // 2
            top = (img.size[1] - s) // 2
            img = img.crop((left, top, left + s, top + s))
            return np.asarray(img, np.float32) / 127.5 - 1.0

        def do_GET(self):
            if self.path == "/healthz":
                dev = service.engine.device
                count = torch.cuda.device_count() if dev.type == "cuda" else 1
                self._json(200, {"status": "ok", "model": model_name, "devices": count})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                if self.path == "/tokenize":
                    idx = service.tokenize(self._read_image())
                    self._json(200, {"indices": idx.reshape(-1).tolist(),
                                     "shape": list(idx.shape)})
                elif self.path == "/detokenize":
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n))
                    idx = np.asarray(req["indices"], np.int32).reshape(req["shape"])
                    self._png(service.detokenize(idx))
                elif self.path == "/reconstruct":
                    idx = service.tokenize(self._read_image())
                    self._png(service.detokenize(idx))
                else:
                    self._json(404, {"error": "unknown path"})
            except Exception as e:
                self._json(500, {"error": repr(e)})

    return Handler


def build_service(base: str, ckpt: str = "", image_size: int = 256, max_batch: int = 8,
                  batch_window_ms: float = 5.0, overrides=(), device=None):
    """The engine of the config ``base`` with the dotlist ``overrides``, no
    loss head, seeded weights or ``ckpt``, on ``device`` (the card by
    default), behind a TokenizerService; (service, model name)."""
    from vqvae_from_gaussian_vae_tpu_torch.models.autoencoder import resolve_device
    from vqvae_from_gaussian_vae_tpu_torch.utils.config import (
        instantiate_from_config, load_config)

    cfg = load_config(base, dotlist=overrides)
    cfg["model"]["params"]["loss_config"] = None
    cfg["model"]["params"].pop("ckpt_path", None)
    engine = instantiate_from_config(cfg["model"], device=resolve_device(device))
    if ckpt:
        engine.load_checkpoint(ckpt)
    service = TokenizerService(engine, image_size, max_batch, batch_window_ms)
    return service, os.path.basename(base)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--base", required=True)
    p.add_argument("--ckpt", default="")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--batch_window_ms", type=float, default=5.0)
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card unless set (cpu for a run without one)")
    args, unknown = p.parse_known_args(argv)

    service, name = build_service(args.base, args.ckpt, args.img_size, args.max_batch,
                                  args.batch_window_ms,
                                  overrides=[u for u in unknown if "=" in u],
                                  device=args.device)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service, name))
    print(f"serving {name} on {args.host}:{args.port} ({service.engine.device})", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
