"""The port's last tool twins (cocosnet_tpu_torch/tools/) against the JAX
repository's tools on the CPU, and the measuring helpers that chip_smoke.py
and the profile twins share (cocosnet_tpu_torch/utils/profiling.py):

- the hand-written kernels' operation counts against PERF.md's kernel table
  (the shift9 forward 185.6 GFLOP at B6 64x64 C 256 D 154, its backward
  701.2 at B8, corr_fwd 82.5 at B6 C 256, corr_bwd 288.8 at B8);
- profile_inference and profile_train at --platform cpu, batch 1, crop 64,
  ngf 8 (f32): every stage or segment present with ms > 0, the residual
  stack's GFLOP 4 x 2 x 2 B H W C^2 9 / 1e9, attend_shift9's the shift9
  forward's count (the plain version's own arithmetic not counted), the
  hand-written calls of each stage, and nothing written inside the
  repository but the --out the test names;
- eval_metrics: swd and fid_from_features equal the JAX tool's on the same
  arrays; the VGG19 features equal JAX's VGG19Features at rel 1e-5 from the
  same random weights (the port's state dict through convert_torch_module);
- mask_to_edge: build_one equals the JAX tool's bit for bit on a synthetic
  CelebA-HQ tree (the JAX native library built as tests/test_native.py
  builds it), and the celebahqedge loader's label stack with no flip or
  crop;
- plot_loss_log: parse of the loss log the port's train twin writes equals
  the JAX tool's;
- every twin raises without a card unless --platform cpu is given.
"""

import ast
import ctypes
import hashlib
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cocosnet_tpu.data import native as JN
from cocosnet_tpu.nn.vgg import VGG19Features as JVGG
from cocosnet_tpu.train.checkpoints import (convert_torch_module,
                                            default_name_map)
from cocosnet_tpu_torch.config import test_defaults
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.data.celebahqedge import CelebAHQEdgeDataset
from cocosnet_tpu_torch.nn.layers import condition_weights
from cocosnet_tpu_torch.nn.vgg import VGG19Features as TVGG
from cocosnet_tpu_torch.tools import eval_metrics as EM
from cocosnet_tpu_torch.tools import mask_to_edge as ME
from cocosnet_tpu_torch.tools import parity_trajectory as PT
from cocosnet_tpu_torch.tools import plot_loss_log as PL
from cocosnet_tpu_torch.tools import profile_inference as PI
from cocosnet_tpu_torch.tools import profile_train as PTR
from cocosnet_tpu_torch.utils import profiling as PR
from test_torch_threads import torch_threads  # noqa: F401
from tools import eval_metrics as JEM
from tools import mask_to_edge as JME
from tools import plot_loss_log as JPL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--platform", "cpu", "--batch", "1", "--crop_size", "64", "--ngf",
         "8", "--compute_dtype", "f32", "--iters", "1"]


# ------------------------------------------------------ operation counts

@pytest.mark.parametrize("count,args,gflop", [
    (PR.shift9_fwd_flops, (6, 4096, 4096, 256, 154), 185.6),
    (PR.shift9_bwd_flops, (8, 4096, 4096, 256, 154), 701.2),
    (PR.corr_fwd_flops, (6, 4096, 4096, 256, 154), 82.5),
    (PR.corr_bwd_flops, (8, 4096, 4096, 256, 154), 288.8),
])
def test_kernel_counts_are_perf_mds(count, args, gflop):
    assert round(count(*args) / 1e9, 1) == gflop


def test_count_flops_replaces_a_plain_versions_arithmetic():
    """On the CPU the counter sees the plain shift9 forward's matmuls; the
    count is the kernel's formula instead, and library ops around it
    count as the counter sees them."""
    from cocosnet_tpu_torch.ops.shift9 import attend_shift9
    g = torch.Generator().manual_seed(0)
    f, k = (torch.randn(1, 8, 8, 16, generator=g) for _ in range(2))
    v = torch.randn(1, 64, 5, generator=g)
    w = torch.randn(5, 7, generator=g)
    got = PR.count_flops(lambda: attend_shift9(f, k, v, 0.01, True) @ w)
    assert got == {"library": 2.0 * 64 * 5 * 7,
                   "kernels": PR.shift9_fwd_flops(1, 64, 64, 16, 5)}


# -------------------------------------------------------- profile twins

def _repo_state():
    """Digests of the files a profile could write into the repository."""
    out = {}
    for rel in ("PROFILE.md", "PROFILE_TRAIN.md",
                os.path.join("build", "profiles", "profile_inference.md"),
                os.path.join("build", "profiles", "profile_train.md")):
        path = os.path.join(ROOT, rel)
        out[rel] = (hashlib.sha1(open(path, "rb").read()).hexdigest()
                    if os.path.exists(path) else None)
    return out


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profiles")
    before = _repo_state()
    inf = PI.main(SMALL + ["--out", str(tmp / "inference.md")])
    train = PTR.main(SMALL + ["--ndf", "8", "--out", str(tmp / "train.md")])
    return dict(inference=inf, train=train, tmp=tmp, before=before,
                after=_repo_state())


def _rows(profiles, which):
    return {r["name"].strip(): r for r in profiles[which]}


def test_profile_inference_has_every_stage(profiles):
    rows = profiles["inference"]
    names = [r["name"] for r in rows]
    want = list(PI.STAGES)
    want[4] = "  adaptor (seg, 151ch)"
    want[7] = "  residual stack (4x183ch)"      # 4 ngf + 151 classes
    assert names == want
    assert all(r["ms"] > 0 and r["profile"] is None for r in rows)


def test_profile_train_has_every_segment(profiles):
    rows = profiles["train"]
    assert [r["name"] for r in rows] == list(PTR.SEGMENTS)
    assert all(r["ms"] > 0 for r in rows)


def test_residual_stack_flops(profiles):
    """4 blocks of two 3x3 convs at C = 183 on the 16 x 16 feature map."""
    row = _rows(profiles, "inference")["residual stack (4x183ch)"]
    c = 4 * 8 + 151
    assert row["gflop"] == pytest.approx(
        4 * 2 * 2 * 1 * 16 * 16 * c * c * 9 / 1e9, rel=1e-12)


def test_attend_shift9_flops_are_the_kernels(profiles):
    row = _rows(profiles, "inference")["attend_shift9 (fused kernel)"]
    want = PR.shift9_fwd_flops(1, 256, 256, 256, 154) / 1e9
    assert row["kernel_gflop"] == row["gflop"] == pytest.approx(want,
                                                                 rel=1e-12)


@pytest.mark.parametrize("which,stage,calls", [
    ("inference", "attend_shift9 (fused kernel)", {"attend_shift9": 1}),
    ("inference", "correlation attend (C=2304)", {}),
    ("train", "full train_step", {"attend_shift9": 1,
                                  "attend_shift9_backward": 1}),
    ("train", "G phase (bwd+adam+EMA)", {"attend_shift9": 1,
                                         "attend_shift9_backward": 1}),
    ("train", "D phase (bwd+adam)", {}),
])
def test_stage_calls(profiles, which, stage, calls):
    """The hand-written kernels' calls (plain versions here) of a stage."""
    row = _rows(profiles, which)[stage]
    assert row["calls"] == calls and row["launches"] == {}


def test_full_inference_is_its_parts(profiles):
    rows = _rows(profiles, "inference")
    full = rows["full inference"]
    parts = {}
    for name in ("correspondence total", "generator total"):
        for k, n in rows[name]["calls"].items():
            parts[k] = parts.get(k, 0) + n
    assert full["calls"] == parts and full["calls"]["attend_shift9"] == 1
    assert full["gflop"] == pytest.approx(
        rows["correspondence total"]["gflop"]
        + rows["generator total"]["gflop"], rel=1e-6)


def test_profiles_write_only_their_out(profiles):
    assert profiles["after"] == profiles["before"]
    for name, head in (("inference.md", "# Inference profile"),
                       ("train.md", "# Train-step profile")):
        text = (profiles["tmp"] / name).read_text()
        assert text.startswith(head) and "| full " in text


# --------------------------------------------------------- eval_metrics

def _images(n, size, seed):
    rs = np.random.RandomState(seed)
    base = rs.rand(n, size // 8, size // 8, 3)
    return np.clip(np.kron(base, np.ones((1, 8, 8, 1))) * 200
                   + rs.rand(n, size, size, 3) * 55, 0, 255).astype(np.uint8)


def test_swd_is_the_jax_tools():
    a, b = _images(3, 64, 1), _images(3, 64, 2)
    assert EM.swd(a, b, n_patches=256) == JEM.swd(a, b, n_patches=256)


def test_fid_is_the_jax_tools():
    rs = np.random.RandomState(0)
    f1, f2 = rs.randn(40, 6), rs.randn(30, 6) * 1.3 + 0.2
    assert EM.fid_from_features(f1, f2) == JEM.fid_from_features(f1, f2)


def test_vgg_features_are_jaxs():
    """At unit signal scale (the seeded init leaves relu5_2 at zero)."""
    vgg = TVGG(vgg_normal_correct=True)
    condition_weights(vgg, torch.Generator().manual_seed(3), "cpu")
    imgs = _images(3, 64, 4)
    got = EM.vgg_features(vgg, imgs, batch_size=2)
    variables = convert_torch_module(
        {k: v.numpy() for k, v in vgg.state_dict().items()},
        default_name_map)
    jx = jnp.asarray(imgs.astype(np.float32) / 127.5 - 1.0)
    want = np.asarray(JVGG(vgg_normal_correct=True).apply(
        variables, jx, ["r52"])[0].mean(axis=(1, 2)))
    assert got.shape == (3, 512) and np.linalg.norm(want) > 0
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_vgg_extractor_warns_without_weights(tmp_path):
    ext = EM.vgg_feature_extractor(device="cpu",
                                   weights=str(tmp_path / "none.npz"))
    assert ext.loaded_weights is None
    assert ext(_images(2, 32, 5)).shape == (2, 512)


# ---------------------------------------------------------- mask_to_edge

@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library, built with native/Makefile's flags
    into a directory of this module's own where it is not built (as
    tests/test_torch_data_configs.py builds it)."""
    if JN.available():
        return
    out = str(tmp_path_factory.mktemp("jax_native") / "libcocosnet_host.so")
    built = subprocess.run(
        ["g++", "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-o", out,
         os.path.join(ROOT, "native", "host_ops.cc")], check=False)
    if built.returncode != 0:
        pytest.skip("native library not built and no toolchain")
    lib = ctypes.CDLL(out)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.distance_transform_l1_u8.argtypes = [u8p, ctypes.c_int,
                                             ctypes.c_int, u8p]
    lib.mask_edges_u8.argtypes = [u8p, u8p, ctypes.c_int, ctypes.c_int]
    lib.canny_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_float, u8p]
    JN._LIB, JN._TRIED = lib, True


@pytest.fixture(scope="module")
def celeb(tmp_path_factory):
    base = tmp_path_factory.mktemp("celeb")
    root, tables = str(base / "celeb"), str(base / "tables")
    SYN.make_celebahq_tree(root, n_train=3, n_val=3, size=80, block=16,
                           seed=2, table_dir=tables)
    return root, tables


@pytest.mark.parametrize("idx", [0, 1, 4])
def test_mask_to_edge_is_the_jax_tools(jax_native, celeb, idx):
    root, _ = celeb
    got = ME.build_one(root, idx, 64)
    want = JME.build_one(root, idx, 64)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (64, 64, 15)
    np.testing.assert_array_equal(got, want)
    assert got[..., 0].any()


@pytest.mark.parametrize("idx", [0, 1])
def test_mask_to_edge_is_the_loaders_stack(celeb, idx):
    """celebahqedge's label tensor with no flip and no crop is the stack /
    255."""
    root, tables = celeb
    ds = CelebAHQEdgeDataset(test_defaults(
        dataset_mode="celebahqedge", dataroot=root, ref_table_dir=tables,
        load_size=64, crop_size=64))
    want = ds.get_label_tensor(ds.imgpath_to_labelpath(
        os.path.join(root, "CelebA-HQ-img", f"{idx}.jpg")),
        {"crop_pos": (0, 0), "flip": False})
    got = ME.build_one(root, idx, 64)
    np.testing.assert_array_equal(got.astype(np.float32) / 255, want)


def test_mask_to_edge_main_writes_the_stacks(celeb, tmp_path):
    root, _ = celeb
    ME.main(["--dataroot", root, "--out", str(tmp_path), "--load_size",
             "32", "--ids", "0-2", "--platform", "cpu"])
    assert sorted(os.listdir(tmp_path)) == [f"0000{i}_edges.npy"
                                            for i in range(3)]
    np.testing.assert_array_equal(np.load(tmp_path / "00001_edges.npy"),
                                  ME.build_one(root, 1, 32))


# --------------------------------------------------------- plot_loss_log

@pytest.fixture(scope="module")
def loss_log(tmp_path_factory):
    """The loss_log.txt of two train-twin iterations on a synthetic ADE20k
    tree (print_freq 1)."""
    from cocosnet_tpu_torch.cli import train as TTRAIN
    from cocosnet_tpu_torch.nn import layers as TL
    base = tmp_path_factory.mktemp("log")
    root = str(base / "ade")
    SYN.make_ade20k_tree(root, n_train=4, n_val=2, size=(80, 72),
                         n_classes=13, block=8)
    policy = TL.get_compute_dtype()
    try:
        TTRAIN.main([
            "--dataset_mode", "ade20k", "--dataroot", root, "--label_nc",
            "12", "--batchSize", "2", "--crop_size", "64", "--load_size",
            "72", "--ngf", "8", "--ndf", "8", "--use_attention", "--maskmix",
            "--warp_mask_losstype", "direct", "--PONO", "--PONO_C",
            "--compute_dtype", "f32", "--nThreads", "2", "--platform", "cpu",
            "--checkpoints_dir", str(base / "ck"), "--name", "log",
            "--niter", "1", "--niter_decay", "0", "--print_freq", "1",
            "--display_freq", "100", "--save_epoch_freq", "100",
            "--output_dir", str(base / "out")])
    finally:
        TL.set_compute_dtype(policy)
    return str(base / "ck" / "log" / "loss_log.txt")


def test_parse_is_the_jax_tools(loss_log):
    got, want = PL.parse(loss_log), JPL.parse(loss_log)
    assert got == want
    idx, steps, curves = got
    assert len(idx) == 2 and "GAN" in curves and "D_real" in curves


def test_plot_loss_log_main_writes_json(loss_log, tmp_path):
    out = tmp_path / "c.json"
    PL.main([loss_log, "--json", str(out), "--platform", "cpu"])
    assert out.read_text().startswith('{"epoch_iters"')


# ----------------------------------------------------- platform guards

@pytest.mark.parametrize("main,argv", [
    (PT.main, ["--steps", "1", "--out", ""]),
    (PI.main, ["--out", ""]),
    (PTR.main, ["--out", ""]),
    (EM.main, ["--fake_dir", ROOT, "--real_dir", ROOT]),
    (ME.main, ["--dataroot", ROOT, "--out", ROOT, "--ids", "0-0"]),
    (PL.main, [os.path.join(ROOT, "README.md")]),
])
def test_twins_ask_for_the_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the twins run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


# ------------------------------------------- the tools' names resolve

TOOLS = sorted(f[:-3] for f in os.listdir(
    os.path.join(ROOT, "cocosnet_tpu_torch", "tools"))
    if f.endswith(".py") and f != "__init__.py")


def _port_names(tree, package):
    """(module, name) of each `from <port module> import name` anywhere in
    the file, and {alias: [module]} of each port module bound by an
    import."""
    import importlib
    wanted, aliases = [], {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = (importlib.util.resolve_name("." * node.level
                                               + (node.module or ""), package)
                   if node.level else node.module)
            if not mod.startswith("cocosnet_tpu_torch"):
                continue
            for a in node.names:
                sub = f"{mod}.{a.name}"
                if importlib.util.find_spec(mod) and _is_module(sub):
                    aliases.setdefault(a.asname or a.name, []).append(sub)
                else:
                    wanted.append((mod, a.name))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("cocosnet_tpu_torch") and a.asname:
                    aliases.setdefault(a.asname, []).append(a.name)
    return wanted, aliases


def _is_module(name):
    import importlib
    try:
        return importlib.util.find_spec(name) is not None
    except ModuleNotFoundError:
        return False


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_names_resolve(tool):
    """Every name a tool imports from the port, at its top or inside a
    function, exists, and so does every attribute it reads of a port
    module it binds to a name (and, in ab_routes, of chip_smoke.py, which
    it loads as `CS`): a helper moved out of a module must take its
    readers along."""
    import importlib
    path = os.path.join(ROOT, "cocosnet_tpu_torch", "tools", tool + ".py")
    tree = ast.parse(open(path).read())
    wanted, aliases = _port_names(tree, "cocosnet_tpu_torch.tools")
    missing = [f"{m}.{n}" for m, n in wanted
               if not hasattr(importlib.import_module(m), n)]
    mods = {a: [importlib.import_module(m) for m in ms]
            for a, ms in aliases.items()}
    if tool == "ab_routes":
        mods["CS"] = [importlib.import_module(
            "cocosnet_tpu_torch.tools.ab_routes")._smoke()]
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in mods
                and not any(hasattr(m, node.attr)
                            for m in mods[node.value.id])):
            missing.append(f"{node.value.id}.{node.attr}")
    assert not missing, f"{tool}: {sorted(set(missing))}"
