"""The port's HTTP service (stutter_tpu_torch.serve, a copy of
stutter_tpu/serve.py over the port's predictors) over a live local server
on the CPU, mirroring tests/test_serve.py; its answers are held to direct
calls and, for the vote, to the JAX package."""

import json
import os
import tempfile
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

CLASSES = ["neg", "pos", "zzz"]


def _wav_bytes(y, sr=16000):
    from stutter_tpu_torch.io.wav import write_wav

    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    write_wav(path, y, sr, subtype="FLOAT")  # exact samples: answers compare to direct calls
    with open(path, "rb") as f:
        data = f.read()
    os.unlink(path)
    return data


def _post(url, data, timeout=300):
    req = urllib.request.Request(url, data=data, method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """An MLP, three heads and a vote over them, in the JAX package's files."""
    from stutter_tpu import persist
    from stutter_tpu.models.scaler import LabelEncoder, StandardScaler
    from stutter_tpu.train.seq_pipeline import ARCHS, persist_seq_head
    from stutter_tpu.train.trainer import FittedMLP, MLPTrainConfig

    out = tmp_path_factory.mktemp("serve")
    rng = np.random.RandomState(41)
    dims = (149, 8, 3)
    params = {}
    for j, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{j}"] = (rng.randn(2, a, b) * np.sqrt(2.0 / a)).astype(np.float32)
        params[f"b{j}"] = (rng.randn(2, b) * 0.1).astype(np.float32)
    persist.save_mlp(out / "model_mlp_tpu",
                     FittedMLP(params=params, n_seeds=2, cfg=MLPTrainConfig(hidden=(8,))))
    persist.save_scaler(out / "scaler_after.npz",
                        StandardScaler.fit(rng.randn(30, 149).astype(np.float32)))
    persist.save_label_encoder(out / "label_encoder.json", LabelEncoder(classes_=CLASSES))
    for i, arch in enumerate(("cnn", "cnn_bilstm", "transformer")):
        spec = ARCHS[arch]
        D = 60 if arch == "cnn_bilstm" else 128
        persist_seq_head(str(out), arch,
                         spec["init_fn"](jax.random.PRNGKey(i), **spec["init_kwargs"](3)),
                         (rng.randn(D) - (30 if D == 128 else 0)).astype(np.float32),
                         (1 + 10 * rng.rand(D)).astype(np.float32), CLASSES)
    with open(out / "ensemble.json", "w") as f:
        json.dump({"weights": {"cnn": 0.5, "cnn_bilstm": 0.3, "transformer": 0.2},
                   "classes": CLASSES}, f)
    return out


def _start(handler):
    from stutter_tpu_torch.serve import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module")
def models(workspace):
    from stutter_tpu_torch.infer import EnsemblePredictor, Predictor, SeqPredictor

    pred = Predictor.load(str(workspace), device="cpu")
    pred.denoise_first = False
    ens = EnsemblePredictor.load(str(workspace), device="cpu")
    return pred, {"ensemble": ens, "cnn": SeqPredictor.load(str(workspace), "cnn", device="cpu")}


@pytest.fixture(scope="module")
def server(models):
    """Micro-batching on (5 ms window), as chip_smoke serves."""
    from stutter_tpu_torch.serve import make_handler

    pred, extra = models
    httpd, base = _start(make_handler(pred, seq_predictors=extra, batch_window_ms=5.0))
    yield base
    httpd.shutdown()
    httpd.server_close()


def test_healthz_and_index_page(server):
    h = json.loads(urllib.request.urlopen(server + "/healthz").read())
    assert h == {"status": "ok", "classes": CLASSES, "n_features": 149,
                 "models": ["cnn", "ensemble", "mlp"]}
    resp = urllib.request.urlopen(server + "/")
    assert resp.headers["Content-Type"].startswith("text/html")
    body = resp.read().decode()
    assert "/healthz" in body and "/predict" in body and "<select id=\"model\">" in body
    assert "http://" not in body and "https://" not in body
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/nope")
    assert e.value.code == 404


@pytest.mark.parametrize("model", ["mlp", "cnn", "ensemble"])
def test_predict_equals_the_direct_call(server, models, model):
    pred, extra = models
    y = (np.random.RandomState(42).randn(16000) * 0.2).astype(np.float32)
    r = _post(server + f"/predict?model={model}&denoise=0", _wav_bytes(y))
    direct = (pred if model == "mlp" else extra[model]).predict_clip(y, denoise=False)
    assert r["label"] == direct["label"]
    for c in CLASSES:
        assert abs(r["proba"][c] - direct["proba"][c]) < 1e-6


def test_ensemble_answer_matches_the_jax_service(workspace, server):
    """The same upload, denoise on, to the port's service and through the
    JAX package's EnsemblePredictor: the same label, the vote within 1e-3."""
    from stutter_tpu.config import PipelineConfig as JConfig
    from stutter_tpu.infer import EnsemblePredictor as JEnsemble

    y = (0.3 * np.sin(2 * np.pi * 330 * np.arange(20000) / 16000)
         + 0.05 * np.random.RandomState(43).randn(20000)).astype(np.float32)
    r = _post(server + "/predict?model=ensemble", _wav_bytes(y))
    ref = JEnsemble.load(str(workspace), JConfig()).predict_clip(y, denoise=True)
    assert r["label"] == ref["label"]
    assert max(abs(r["proba"][c] - ref["proba"][c]) for c in CLASSES) < 1e-3


def test_predict_resamples(server, models):
    pred, _ = models
    y22 = (np.random.RandomState(44).randn(22050) * 0.2).astype(np.float32)
    r = _post(server + "/predict?denoise=0", _wav_bytes(y22, sr=22050))
    assert r == pred.predict_clip(y22, sr=22050, denoise=False)


def test_bad_requests(server):
    """Unknown model 400, undecodable body 400, oversized upload 413, a
    model without predict_stream on /stream 400."""
    data = _wav_bytes((np.random.RandomState(45).randn(8000) * 0.2).astype(np.float32))
    for path, body in (("/predict?model=nope", data), ("/predict", b"not a wav"),
                       ("/stream?model=cnn", data)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server + path, body)
        assert e.value.code == 400, path
    req = urllib.request.Request(server + "/predict", data=data, method="POST")
    req.add_header("Content-Length", str(500 * 1024 * 1024))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 413


@pytest.mark.parametrize("model", ["mlp", "ensemble"])
def test_stream_equals_the_direct_call(server, models, model):
    pred, extra = models
    m = pred if model == "mlp" else extra[model]
    y = (np.random.RandomState(46).randn(16000 * 4) * 0.2).astype(np.float32)
    wins = _post(server + f"/stream?model={model}&window=1&hop=1", _wav_bytes(y))
    direct = m.predict_stream(y, 16000, window_s=1.0, hop_s=1.0)
    assert len(wins) == len(direct) == 4
    for w, d in zip(wins, direct):
        assert (w["start_s"], w["end_s"], w["label"]) == (d["start_s"], d["end_s"], d["label"])
        for c in CLASSES:
            assert abs(w["proba"][c] - d["proba"][c]) < 1e-6


def test_concurrent_predicts_batch_per_flag_and_equal_the_direct_calls(models):
    """Micro-batching: concurrent /predict?model=ensemble requests share
    predict_batch passes grouped by their denoise flag (a generous window
    so slow threads land together); every answer equals predict_clip of its
    clip, and a concurrent /stream answers alongside."""
    from stutter_tpu_torch.serve import make_handler

    pred, extra = models
    ens = extra["ensemble"]
    calls = []
    real = ens.predict_batch

    def counting(clips, sr=16000, denoise=None):
        calls.append((len(clips), denoise))
        return real(clips, sr=sr, denoise=denoise)

    ens.predict_batch = counting
    httpd, base = _start(make_handler(pred, seq_predictors=extra, batch_window_ms=300.0))
    try:
        rng = np.random.RandomState(47)
        clips = [(rng.randn(12000 + 2000 * i) * 0.2).astype(np.float32) for i in range(5)]
        results, errors = [None] * 6, []

        def post(i, path, y):
            try:
                results[i] = _post(base + path, _wav_bytes(y))
            except Exception as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=post, args=(i, "/predict?model=ensemble&denoise=0",
                                                        clips[i])) for i in range(4)]
        threads.append(threading.Thread(target=post, args=(4, "/predict?model=ensemble",
                                                           clips[4])))
        long_clip = (rng.randn(16000 * 3) * 0.2).astype(np.float32)
        threads.append(threading.Thread(target=post, args=(5, "/stream?model=mlp", long_clip)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errors and not any(t.is_alive() for t in threads), errors
    finally:
        ens.predict_batch = real
        httpd.shutdown()
        httpd.server_close()
    assert sum(n for n, _ in calls) == 5 and max(n for n, _ in calls) >= 2, calls
    assert {dn for _, dn in calls} == {False, True}
    for i, y in enumerate(clips):
        direct = ens.predict_clip(y, denoise=i == 4)
        assert results[i]["label"] == direct["label"]
        for c in CLASSES:
            assert abs(results[i]["proba"][c] - direct["proba"][c]) < 1e-5
    assert results[5] == pred.predict_stream(long_clip, 16000)


def test_micro_batcher_arrivals_fast_path():
    """With the arrivals gauge at zero a lone request dispatches at once,
    far under the window; a burst dispatches when its last member queues,
    as one batch; without a gauge the worker waits the window out."""
    from stutter_tpu_torch.serve import _Gauge, _MicroBatcher

    class Stub:
        def __init__(self):
            self.sizes = []

        def predict_batch(self, ys, sr, denoise):
            self.sizes.append(len(ys))
            return [{"label": "neg", "n": len(y)} for y in ys]

    window_s, y = 3.0, np.zeros(4000, np.float32)
    gauge, stub = _Gauge(), Stub()
    b = _MicroBatcher(stub, window_ms=window_s * 1e3, max_batch=8, arrivals=gauge)
    gauge.inc()
    t0 = time.time()
    assert b.predict(y, 16000, False, on_queued=gauge.dec)["label"] == "neg"
    assert time.time() - t0 < window_s / 2 and stub.sizes == [1] and gauge.value() == 0

    gauge2, stub2, n = _Gauge(), Stub(), 4
    b2 = _MicroBatcher(stub2, window_ms=window_s * 1e3, max_batch=8, arrivals=gauge2)
    for _ in range(n):
        gauge2.inc()
    results, barrier = [None] * n, threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = b2.predict(y, 16000, False, on_queued=gauge2.dec)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=window_s * 3)
    assert all(r is not None for r in results) and time.time() - t0 < window_s / 2
    assert sum(stub2.sizes) == n and max(stub2.sizes) >= 2 and gauge2.value() == 0

    stub3 = Stub()
    t0 = time.time()
    _MicroBatcher(stub3, window_ms=200.0, max_batch=8).predict(y, 16000, False)
    assert time.time() - t0 >= 0.18


def test_predict_not_blocked_by_stream(models):
    """An in-flight /stream does not block /predict: streams take their own
    lock, predicts per-model locks."""
    from stutter_tpu_torch.infer import Predictor
    from stutter_tpu_torch.serve import make_handler

    pred, _ = models
    slow = Predictor(scaler=pred.scaler, label_encoder=pred.label_encoder, model=pred.model,
                     device=pred.device, denoise_first=False)
    gate, started = threading.Event(), threading.Event()

    def slow_stream(y, sr, window_s=3.0, hop_s=1.0):
        started.set()
        assert gate.wait(timeout=60)
        return []

    slow.predict_stream = slow_stream
    httpd, base = _start(make_handler(slow))
    try:
        clip = _wav_bytes((np.random.RandomState(48).randn(16000) * 0.2).astype(np.float32))
        out = {}
        st = threading.Thread(target=lambda: out.update(s=_post(base + "/stream", clip)))
        st.start()
        assert started.wait(timeout=30)
        r = _post(base + "/predict?denoise=0", clip, timeout=60)
        assert r["label"] in CLASSES and not gate.is_set() and st.is_alive()
        gate.set()
        st.join(timeout=60)
        assert not st.is_alive() and out["s"] == []
    finally:
        gate.set()
        httpd.shutdown()
        httpd.server_close()


def test_serve_builds_the_models_on_the_device(workspace):
    """serve() loads the MLP, the heads and the vote on the given device,
    warms them and binds; cuda without a GPU raises before binding."""
    from stutter_tpu_torch.serve import serve

    httpd = serve(str(workspace), port=0, seq_arches=("cnn",), ensemble=True,
                  batch_window_ms=5.0, device="cpu", warmup=False)
    try:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        h = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{httpd.server_port}/healthz").read())
        assert h["models"] == ["cnn", "ensemble", "mlp"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serve(str(workspace), port=0, ensemble=True)


def test_cli_predict_stream_on_cpu_and_cuda_raises_without_a_gpu(workspace, tmp_path, capsys):
    """predict --arch ensemble / cnn_bilstm and stream --arch ensemble / mlp
    on the CPU's plain path; without a GPU, cuda (the default) raises for
    predict, stream and serve instead of falling back."""
    from stutter_tpu_torch import cli
    from stutter_tpu_torch.io.wav import write_wav

    root = tmp_path / "ws"
    root.mkdir()
    os.symlink(workspace, root / "output_results")
    wav = tmp_path / "c.wav"
    write_wav(wav, (np.random.RandomState(49).randn(16000 * 3) * 0.2).astype(np.float32), 16000,
              subtype="FLOAT")
    for arch in ("ensemble", "cnn_bilstm"):
        assert cli.main(["predict", str(wav), "--root", str(root), "--arch", arch,
                         "--device", "cpu"]) == 0
        res = json.loads(capsys.readouterr().out)
        assert res["label"] in CLASSES and abs(sum(res["proba"].values()) - 1) < 1e-5
    for arch in ("ensemble", "mlp"):
        assert cli.main(["stream", str(wav), "--root", str(root), "--arch", arch,
                         "--window", "1", "--hop", "1", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 3 and all(ln.split()[-1] in CLASSES for ln in lines)
    if not torch.cuda.is_available():
        for cmd in (["predict", str(wav), "--arch", "ensemble"], ["stream", str(wav)],
                    ["serve", "--ensemble", "--port", "0"]):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                cli.main([*cmd, "--root", str(root)])
