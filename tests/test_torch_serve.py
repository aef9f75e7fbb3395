"""The port's serving path on the CPU at 64 px (ngf 16, label_nc 12, batch
2, f32), on a synthetic ADE20k tree, with G and Corr at unit signal scale
saved as the reference's flat latest_net_{G,Corr}.pth:

- the serve twin (`cocosnet_tpu_torch.tools.serve`, --platform cpu
  --once) writes, for every request, the bytes of the port's eager
  make_inference_step on the batches it dispatched, quantized with
  tools/serve.py's formula (round half up, in numpy here);
- JAX's own tools/serve.py, run in-process with --once on the same
  requests and the same .pth files (its torch-checkpoint path), writes
  PNGs within 1 level of the twin's;
- npy results are the PNGs' bytes, jpg results PIL's quality-92 JPEG of
  them;
- a bad request gets its .error.txt, and so does one whose pipeline
  raises, without a hang; random weights and the unported dataset modes
  are refused;
- tools/export_inference.py's twin turns a train checkpoint into
  state_infer_<label>/ (the EMA shadows under --use_ema), which
  checkpoints.load_inference and the test twin read first;
- the bench_serve twin prints its JSON line for 4 requests.

Every server run happens on a thread joined with a time limit, so a hang
fails the test instead of the suite."""

import importlib.util
import io
import json
import os
import random
import shutil
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch import pix2pix as TP
from cocosnet_tpu_torch.cli import test as TTEST
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.data import transforms as T
from cocosnet_tpu_torch.data.ade20k import ADE20KDataset
from cocosnet_tpu_torch.nn import layers as TL
from cocosnet_tpu_torch.tools import bench_serve as BS
from cocosnet_tpu_torch.tools import export_inference as EX
from cocosnet_tpu_torch.tools import serve as SV
from cocosnet_tpu_torch.train import checkpoints as C
from cocosnet_tpu_torch.train import state as TS
from cocosnet_tpu_torch.train.steps import make_inference_step
from test_torch_threads import thread_share, torch_threads  # noqa: F401
from torch_fixtures import condition

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--dataset_mode", "ade20k", "--label_nc", "12", "--crop_size",
         "64", "--load_size", "64", "--ngf", "16", "--use_attention",
         "--maskmix", "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
         "--compute_dtype", "f32", "--batchSize", "2", "--nThreads", "2"]
N_REQUESTS = 3
RUN_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _port_policy():
    """The twins set the port's process-wide conv policy; restore it."""
    prev = TL.get_compute_dtype()
    yield
    TL.set_compute_dtype(prev)


@pytest.fixture(scope="module")
def site():
    """A synthetic tree, a checkpoints dir holding conditioned weights as
    flat .pth files under the name "serve", and a watch dir of
    N_REQUESTS requests r<i>: label i, exemplar (photo and label) i + 1."""
    base = tempfile.mkdtemp(prefix="tserve_")
    root = os.path.join(base, "ade")
    SYN.make_ade20k_tree(root, n_train=6, n_val=2, size=(80, 72),
                         n_classes=13, block=8)
    ck = os.path.join(base, "ck")
    opt = TCFG.parse_options(MODEL + ["--checkpoints_dir", ck, "--name",
                                      "serve"], is_train=False)
    nets = TP.Pix2PixNets(opt, device="cpu")
    condition(nets.gen, 21)
    condition(nets.corr, 22)
    os.makedirs(os.path.join(ck, "serve"))
    torch.save(nets.gen.state_dict(),
               os.path.join(ck, "serve", "latest_net_G.pth"))
    torch.save(nets.corr.state_dict(),
               os.path.join(ck, "serve", "latest_net_Corr.pth"))
    train = os.path.join(root, "training")
    watch = os.path.join(base, "in")
    _write_requests(watch, train, N_REQUESTS)
    yield {"base": base, "root": root, "ck": ck, "watch": watch,
           "train": train}
    shutil.rmtree(base, ignore_errors=True)


def _write_requests(watch, train, n):
    os.makedirs(watch, exist_ok=True)
    stems = sorted(f[:-4] for f in os.listdir(train) if f.endswith(".jpg"))
    for i in range(n):
        a, b = stems[i], stems[i + 1]
        shutil.copy(os.path.join(train, a + ".png"),
                    os.path.join(watch, f"r{i}.label.png"))
        shutil.copy(os.path.join(train, b + ".png"),
                    os.path.join(watch, f"r{i}.ref_label.png"))
        shutil.copy(os.path.join(train, b + ".jpg"),
                    os.path.join(watch, f"r{i}.ref.jpg"))


def _bounded(fn, *args):
    """fn(*args) on a thread joined within RUN_TIMEOUT_S; its result, or
    its exception raised here."""
    box = {}

    def run():
        try:
            box["result"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=RUN_TIMEOUT_S)
    assert not t.is_alive(), f"{fn.__module__}.{fn.__name__} did not return"
    if "error" in box:
        raise box["error"]
    return box["result"]


def _serve_argv(site, out, *extra, name="serve"):
    return MODEL + ["--watch_dir", site["watch"], "--out_dir", out, "--once",
                    "--poll_s", "0.05", "--checkpoints_dir", site["ck"],
                    "--name", name, "--platform", "cpu", *extra]


@pytest.fixture(scope="module")
def served(site):
    """The twin's PNG run: (ServeRun, out dir)."""
    out = os.path.join(site["base"], "out_png")
    prev = TL.get_compute_dtype()
    try:
        run = _bounded(SV.main, _serve_argv(site, out))
    finally:
        TL.set_compute_dtype(prev)
    return run, out


def _read(path):
    if path.endswith(".npy"):
        return np.load(path)
    return np.asarray(Image.open(path))


def test_serve_twin_matches_the_eager_step_byte_for_byte(site, served):
    run, out = served
    assert run.served == N_REQUESTS and run.failed == 0
    assert sorted(r for b in run.batches for r in b) == [
        f"r{i}" for i in range(N_REQUESTS)]
    assert all(1 <= len(b) <= 2 for b in run.batches)
    assert len(run.latencies_ms) == N_REQUESTS
    # the requests through the port's dataset pipeline, and the eager step
    opt = TCFG.parse_options(MODEL + ["--checkpoints_dir", site["ck"],
                                      "--name", "serve"], is_train=False)
    nets = TP.Pix2PixNets(opt, device="cpu")
    assert "latest_net_G.pth" in C.load_inference(opt, nets, "latest")
    ds = ADE20KDataset.__new__(ADE20KDataset)
    ds.opt, ds.rng = opt, random.Random(0)
    step = make_inference_step(nets)

    def item(r):
        w = site["watch"]
        lp = os.path.join(w, r + ".label.png")
        rlp = os.path.join(w, r + ".ref_label.png")
        params = ds.label_params(rlp)
        ref = T.image_to_tensor(opt, Image.open(
            os.path.join(w, r + ".ref.jpg")).convert("RGB"), params)
        return {"label": ds.get_label_tensor(lp, ds.label_params(lp)),
                "ref": ref, "label_ref": ds.get_label_tensor(rlp, params)}

    for reqs in run.batches:
        batch = {k: np.zeros((2, 64, 64, c), np.float32)
                 for k, c in (("label", 1), ("image", 3), ("ref", 3),
                              ("label_ref", 1))}
        batch["self_ref"] = np.zeros((2,), np.float32)
        for j, r in enumerate(reqs):
            for k, v in item(r).items():
                batch[k][j] = v
        y = step(batch)["fake_image"].numpy()
        want = np.clip(np.floor((y + np.float32(1.0)) * np.float32(127.5)
                                + np.float32(0.5)), 0, 255).astype(np.uint8)
        for j, r in enumerate(reqs):
            got = _read(os.path.join(out, r + ".png"))
            assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
            np.testing.assert_array_equal(got, want[j])
    assert want.std() > 10  # the outputs are far from flat


def _jax_serve(argv, monkeypatch):
    """JAX's tools/serve.py main, in-process, with the repository's test.py
    as the `test` module it imports."""
    spec = importlib.util.spec_from_file_location(
        "jax_test_cli", os.path.join(ROOT, "test.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setitem(sys.modules, "test", cli)
    import tools.serve as jserve
    monkeypatch.setattr("sys.argv", ["serve.py"] + argv)
    jserve.main()


def test_serve_twin_matches_jax_serve(site, served, monkeypatch):
    _, out = served
    jout = os.path.join(site["base"], "out_jax")
    _bounded(_jax_serve, _serve_argv(site, jout), monkeypatch)
    for i in range(N_REQUESTS):
        got = _read(os.path.join(out, f"r{i}.png")).astype(np.int32)
        want = _read(os.path.join(jout, f"r{i}.png")).astype(np.int32)
        assert got.shape == want.shape == (64, 64, 3)
        assert np.abs(got - want).max() <= 1, i


@pytest.mark.parametrize("fmt", ["npy", "jpg"])
def test_serve_twin_out_formats(site, served, fmt):
    _, png_out = served
    out = os.path.join(site["base"], f"out_{fmt}")
    run = _bounded(SV.main, _serve_argv(site, out, "--out_format", fmt))
    assert run.served == N_REQUESTS
    for i in range(N_REQUESTS):
        got = _read(os.path.join(out, f"r{i}.{fmt}"))
        want = _read(os.path.join(png_out, f"r{i}.png"))
        assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
        if fmt == "jpg":   # the lossless result through PIL at quality 92
            buf = io.BytesIO()
            Image.fromarray(want).save(buf, format="JPEG", quality=92)
            want = np.asarray(Image.open(buf))
        np.testing.assert_array_equal(got, want)


def test_serve_twin_writes_an_error_for_a_bad_request(site):
    watch = os.path.join(site["base"], "in_bad")
    os.makedirs(watch)
    # an exemplar photo but no label: an error file, no crash
    shutil.copy(os.path.join(site["watch"], "r0.ref.jpg"),
                os.path.join(watch, "x.ref.jpg"))
    out = os.path.join(site["base"], "out_bad")
    argv = _serve_argv(site, out)
    argv[argv.index("--watch_dir") + 1] = watch
    run = _bounded(SV.main, argv)
    assert (run.served, run.failed, run.batches) == (0, 1, [])
    with open(os.path.join(out, "x.error.txt")) as f:
        assert "ValueError: missing" in f.read()


def test_serve_twin_survives_a_pipeline_exception(site, monkeypatch):
    """An exception the pipeline was not expected to raise still gives an
    .error.txt, and --once returns."""
    def boom(self, path, params):
        raise RuntimeError("synthetic pipeline failure")

    monkeypatch.setattr(ADE20KDataset, "get_label_tensor", boom)
    out = os.path.join(site["base"], "out_boom")
    run = _bounded(SV.main, _serve_argv(site, out))
    assert (run.served, run.failed) == (0, N_REQUESTS)
    for i in range(N_REQUESTS):
        with open(os.path.join(out, f"r{i}.error.txt")) as f:
            assert "RuntimeError: synthetic pipeline failure" in f.read()


@pytest.mark.parametrize("mode", ["random weights", "celebahq",
                                  "celebahqedge", "deepfashion"])
def test_serve_twin_refuses(site, mode):
    out = os.path.join(site["base"], "out_refused")
    if mode == "random weights":
        with pytest.raises(SystemExit, match="refusing to serve random"):
            SV.main(_serve_argv(site, out, name="absent"))
        return
    with pytest.raises(SystemExit, match="ROADMAP Queue 1 item 5"):
        SV.main(_serve_argv(site, out, "--dataset_mode", mode))


@pytest.mark.parametrize("use_ema", [True, False])
def test_export_writes_what_load_inference_and_the_test_twin_read(
        site, use_ema, capsys):
    name = f"export_ema{int(use_ema)}"
    flags = MODEL + ["--checkpoints_dir", site["ck"], "--name", name,
                     "--platform", "cpu", "--dataroot", site["root"]]
    train_flags = flags + ["--ndf", "8"] + (["--use_ema"] if use_ema else [])
    opt = TCFG.parse_options(train_flags, is_train=True)
    nets = TP.Pix2PixNets(opt, device="cpu", seed=3)
    state = TS.create_train_state(opt, nets)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in list(state.g_params.values()) + (
                list(state.ema.values()) if use_ema else []):
            p.add_(torch.randn(p.shape, generator=g) * 0.01)
    C.save_state(opt, state, nets, "latest")
    path = EX.main(train_flags)
    assert path == C.ckpt_dir(opt, "infer_latest")
    assert sorted(os.listdir(path)) == ["net_Corr.pth", "net_G.pth"]
    want = TS.ema_state_dicts(state, nets) if use_ema else {
        n: getattr(nets, n).state_dict() for n in ("gen", "corr")}
    if use_ema:   # the shadows are not the parameters
        assert any(not torch.equal(v, nets.gen.state_dict()[k])
                   for k, v in want["gen"].items())
    # the test twin, without --use_ema, takes state_infer_latest first
    capsys.readouterr()
    run = TTEST.main(flags + ["--how_many", "2", "--output_dir",
                              os.path.join(site["base"], "out_" + name)])
    assert "state_infer_latest/net_G.pth" in capsys.readouterr().out
    assert run.images == 2
    for net in ("gen", "corr"):
        got = getattr(run.nets, net).state_dict()
        assert got.keys() == want[net].keys()
        for k, v in got.items():
            assert torch.equal(v, want[net][k]), (net, k)


def test_bench_serve_prints_its_json_line(site, monkeypatch, capsys):
    monkeypatch.chdir(site["base"])   # the server is found from any dir
    monkeypatch.setenv("OMP_NUM_THREADS", str(thread_share()))
    argv = ["--src_dir", site["train"], "--n_requests", "4", "--warmup",
            "2", "--timeout_s", "90", "--"] + MODEL + [
        "--checkpoints_dir", site["ck"], "--name", "serve", "--platform",
        "cpu", "--out_format", "npy"]
    result = _bounded(BS.main, argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    assert set(result) == {"n_requests", "arrival_rate_rps",
                           "throughput_rps", "latency_ms"}
    assert set(result["latency_ms"]) == {"p50", "p90", "p99", "max"}
    assert result["n_requests"] == 4 and result["throughput_rps"] > 0
    lat = result["latency_ms"]
    assert 0 < lat["p50"] <= lat["p99"] <= lat["max"]
