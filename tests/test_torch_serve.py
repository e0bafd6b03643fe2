"""The port's serving daemon (``python -m vqvae_from_gaussian_vae_tpu_torch.serve``)
against the JAX package's (``serve.py``).

Every test of ``tests/test_serve.py`` runs here against the port's daemon on
the same tiny engine with ``--device cpu``.  The JAX daemon is built by its
own ``build_service`` on ``jax.eval_shape`` templates (no JAX init is
compiled) and then carries the port engine's seeded weights through the JAX
package's ``convert_state_dict`` (strict), so that the same image gives the
same indices through both daemons and the same indices PNGs within one uint8
level.
"""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import serve as jax_serve
from tests.test_torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)
from vqvae_from_gaussian_vae_tpu.models.autoencoder import AutoencodingEngine as JaxEngine
from vqvae_from_gaussian_vae_tpu.utils.torch_convert import convert_state_dict
from vqvae_from_gaussian_vae_tpu_torch import serve as port_serve

PKG = "vqvae_from_gaussian_vae_tpu"
CONFIG = f"""
model:
  target: {PKG}.models.autoencoder.AutoencodingEngine
  params:
    input_key: img
    regularizer_config:
      target: {PKG}.quantization.gaussian.GaussianQuantRegularizer
      params: {{format: bchw, group: 4, n_samples: 256, seed: 7, backend: xla}}
    encoder_config:
      target: {PKG}.models.unet.Encoder
      params: &enc {{attn_type: vanilla, double_z: true, z_channels: 4,
        resolution: 32, in_channels: 3, out_ch: 3, ch: 32, ch_mult: [1, 2],
        num_res_blocks: 1, attn_resolutions: [], dropout: 0.0}}
    decoder_config:
      target: {PKG}.models.unet.Decoder
      params: *enc
"""


def _start(mod, service, name):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(service, name))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.yaml"
    path.write_text(CONFIG)
    return str(path)


def _template_params(engine, rng=None, example=None):
    """The JAX engine's parameter tree as zeros, from ``jax.eval_shape``."""
    x = engine._example_input()
    tree = jax.eval_shape(lambda x: engine.module.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, x,
        train=False), x)["params"]
    engine.params = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), tree)
    return engine.params


@pytest.fixture(scope="module")
def daemons(config):
    """(port service, port URL, JAX URL): the JAX engine holds the port
    engine's weights."""
    service, name = port_serve.build_service(config, image_size=32, batch_window_ms=20.0,
                                             device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxEngine, "init_params", _template_params)
        jservice, jname = jax_serve.build_service(config, image_size=32, batch_window_ms=20.0)
    jservice.engine.params, _, _ = convert_state_dict(service.engine.state_dict(),
                                                      jservice.engine.params, strict=True)
    port_httpd, port_url = _start(port_serve, service, name)
    jax_httpd, jax_url = _start(jax_serve, jservice, jname)
    yield service, port_url, jax_url
    port_httpd.shutdown()
    jax_httpd.shutdown()


@pytest.fixture(scope="module")
def server(daemons):
    return daemons[1]


def _png_bytes(seed=0, size=40):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
        buf, format="PNG")
    return buf.getvalue()


def _post(url, data, content_type="image/png"):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": content_type})
    with urllib.request.urlopen(req) as r:
        return r.read()


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz") as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "model": "tiny.yaml", "devices": 1}


def test_tokenize_detokenize_roundtrip(server):
    tok = json.loads(_post(f"{server}/tokenize", _png_bytes()))
    assert tok["shape"] == [16, 16, 1]
    assert all(0 <= i < 256 for i in tok["indices"])
    img = Image.open(io.BytesIO(_post(f"{server}/detokenize", json.dumps(tok).encode(),
                                      "application/json")))
    assert img.size == (32, 32)


def test_reconstruct_and_concurrent_batching(server):
    results = {}

    def hit(i):
        results[i] = _post(f"{server}/reconstruct", _png_bytes(i))

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and len(results) == 4
    for body in results.values():
        assert Image.open(io.BytesIO(body)).size == (32, 32)


def test_batch_buckets():
    b = port_serve.TokenizerService._bucket
    assert [b(n, 8) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    assert b(9, 8) == 9  # a drain larger than max_batch (bounded by the queue, but defensive)
    assert all(b(n, 8) == jax_serve.TokenizerService._bucket(n, 8) for n in range(1, 20))


def test_padded_batch_matches_solo(server):
    """An odd-sized concurrent drain pads to the next bucket; each reply must
    still be that request's own tokens (identical to a solo call)."""
    png = _png_bytes(11)

    def tok(out, i):
        out[i] = json.loads(_post(f"{server}/tokenize", png))

    solo = {}
    tok(solo, 0)
    out = {}
    threads = [threading.Thread(target=tok, args=(out, i)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for i in range(3):
        assert out[i]["indices"] == solo[0]["indices"]


def test_drained_counts(daemons):
    """Requests released together inside one batch window drain as one
    padded batch, and ``drained`` counts it with its requests."""
    service, server, _ = daemons
    n = 3
    before = {k: dict(v) for k, v in service.drained.items()}
    barrier, out = threading.Barrier(n), {}

    def tok(i):
        barrier.wait()
        out[i] = json.loads(_post(f"{server}/tokenize", _png_bytes(20 + i)))

    window, service.window = service.window, 2.0
    try:
        threads = [threading.Thread(target=tok, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        service.window = window
    assert len(out) == n
    assert service.drained["tokenize"] == {"batches": before["tokenize"]["batches"] + 1,
                                           "requests": before["tokenize"]["requests"] + n}
    assert service.drained["detokenize"] == before["detokenize"]


def test_error_paths(daemons):
    service, server, _ = daemons
    with pytest.raises(urllib.error.HTTPError) as exc:  # malformed image
        _post(f"{server}/tokenize", b"not an image")
    assert exc.value.code == 500
    with pytest.raises(urllib.error.HTTPError) as exc:  # unknown route
        urllib.request.urlopen(f"{server}/nope")
    assert exc.value.code == 404
    # a batch the engine refuses is a 500 for its requests; the worker lives on
    bad = json.dumps({"indices": [10 ** 6], "shape": [1, 1, 1]}).encode()  # past the codebook
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(f"{server}/detokenize", bad, "application/json")
    assert exc.value.code == 500 and service.worker_alive()
    assert json.loads(_post(f"{server}/tokenize", _png_bytes(3)))["shape"] == [16, 16, 1]


def test_replies_match_the_jax_daemon(daemons):
    """The same image through both daemons: indices equal; the same indices
    through both detokenizers: PNGs within one uint8 level."""
    _, port_url, jax_url = daemons
    for seed in (0, 5):
        png = _png_bytes(seed, size=48)
        got = json.loads(_post(f"{port_url}/tokenize", png))
        want = json.loads(_post(f"{jax_url}/tokenize", png))
        assert got == want
        tok = json.dumps(want).encode()
        a, b = (np.asarray(Image.open(io.BytesIO(_post(f"{u}/detokenize", tok,
                                                       "application/json"))), np.int32)
                for u in (port_url, jax_url))
        assert a.shape == b.shape == (32, 32, 3) and int(np.abs(a - b).max()) <= 1


def test_main_runs_on_the_card_unless_asked(config):
    """Without --device the daemon's engine is the card's, and building it
    raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.main(["--base", config, "--port", "0"])
