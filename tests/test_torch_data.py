"""The port's data pipeline against the JAX package's: on a synthetic ADE20k
tree (cocosnet_tpu_torch.data.synthetic, photos larger than the load size
so the resize and the random crop run) and on tests/fixtures_util's
synthetic Flickr tree, `create_dataloader` of both packages yields the
same batches, bit for bit, in the same order: the seeded shuffle over two
epochs, the seeded crop, flip and exemplar pairing of the train phase, the
ragged last batch of the test phase. The port's loader makes every draw of
the dataset's one seeded generator on its own thread in index order, so
its train phase on the thread pool gives the JAX loader's items on one
thread (the JAX loader's threads draw in whatever order they run); the
test phase draws nothing that changes an item, so there both loaders run
on the thread pool with two batches in flight."""

import os
import pathlib
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

from cocosnet_tpu import config as JCFG
from cocosnet_tpu.data import loader as JLD
from cocosnet_tpu_torch import config as TCFG
from cocosnet_tpu_torch.data import loader as TLD
from cocosnet_tpu_torch.data import synthetic as SYN
from cocosnet_tpu_torch.data import transforms as TT
from test_torch_threads import torch_threads  # noqa: F401

sys.path.insert(0, os.path.dirname(__file__))
from fixtures_util import make_flickr_fixture  # noqa: E402


@pytest.fixture(scope="module")
def roots():
    """{dataset_mode: dataroot}; the roots hold neither 'validation' nor
    'test', which the datasets' exemplar paths replace."""
    base = tempfile.mkdtemp(prefix="tdata_")
    ade = os.path.join(base, "ade")
    SYN.make_ade20k_tree(ade, n_train=7, n_val=5, size=(96, 80),
                         n_classes=13, block=8)
    flickr = pathlib.Path(base) / "flickr"
    make_flickr_fixture(flickr, n_images=5)
    yield {"ade20k": ade, "flickr": str(flickr)}
    shutil.rmtree(base, ignore_errors=True)


def _argv(mode, root, is_train, threads):
    argv = ["--dataset_mode", mode, "--dataroot", root, "--label_nc", "20",
            "--batchSize", "2", "--crop_size", "64", "--nThreads",
            str(threads), "--seed", "3"]
    if mode == "flickr":
        argv += ["--ref_table_dir", root, "--no_pairing_check"]
    return argv + (["--load_size", "72"] if is_train else
                   ["--load_size", "64"])


def _batches(create, opt, epochs):
    loader = create(opt)
    return len(loader), [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("mode", ["ade20k", "flickr"])
@pytest.mark.parametrize("is_train,threads", [(True, 0), (True, 3),
                                              (False, 3)])
def test_loader_matches_jax(roots, mode, is_train, threads):
    argv = _argv(mode, roots[mode], is_train, threads)
    jargv = _argv(mode, roots[mode], is_train, 0 if is_train else threads)
    n_j, want = _batches(JLD.create_dataloader,
                         JCFG.parse_options(jargv, is_train=is_train), 2)
    n_t, got = _batches(TLD.create_dataloader,
                        TCFG.parse_options(argv, is_train=is_train), 2)
    # 7 ADE20k / 5 Flickr training photos in whole batches of 2; 5
    # validation photos of each in batches of 2, 2 and 1
    assert n_t == n_j == (3 if mode == "ade20k" or not is_train else 2)
    assert len(got) == len(want) == 2 * n_j
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["path"] == w["path"]
        for k in ("label", "image", "ref", "label_ref", "self_ref"):
            assert g[k].dtype == w[k].dtype == np.float32
            assert np.array_equal(g[k], w[k]), k
    if is_train:
        # the two epochs' orders differ (the shuffle is drawn again), and the
        # pairing drew both kinds of exemplar
        orders = [[p for b in got[e * n_t:(e + 1) * n_t] for p in b["path"]]
                  for e in (0, 1)]
        assert orders[0] != orders[1]
        self_ref = np.concatenate([b["self_ref"] for b in got])
        assert 0 < self_ref.sum() < len(self_ref)
    else:
        assert [len(b["path"]) for b in got[:n_t]] == [2, 2, 1]


def test_loader_batches_hold_the_label_classes(roots):
    """Labels are integer class ids within [0, label_nc], the photos in
    [-1, 1], and the ragged test batch keeps its one item."""
    opt = TCFG.parse_options(_argv("ade20k", roots["ade20k"], False, 0),
                             is_train=False)
    batch = next(iter(TLD.create_dataloader(opt)))
    lab = batch["label"]
    assert lab.shape == (2, 64, 64, 1)
    assert np.array_equal(lab, np.round(lab)) and lab.min() >= 0
    assert lab.max() <= opt.label_nc
    assert batch["image"].min() >= -1 and batch["image"].max() <= 1


def test_to_device_keeps_the_arrays_and_the_paths():
    batch = {"label": np.arange(6, dtype=np.float32).reshape(1, 2, 3, 1),
             "self_ref": np.ones(1, np.float32), "path": ["a.jpg"]}
    arrays, paths = TLD.to_device(batch, torch.device("cpu"))
    assert paths == {"path": ["a.jpg"]}
    assert set(arrays) == {"label", "self_ref"}
    assert torch.equal(arrays["label"], torch.from_numpy(batch["label"]))


def test_unported_dataset_modes_are_refused(roots):
    opt = TCFG.test_defaults(dataset_mode="celebahq", dataroot=roots["ade20k"])
    with pytest.raises(ValueError, match="celebahq"):
        TLD.create_dataloader(opt)


@pytest.mark.parametrize("mode", ["resize_and_crop", "scale_width_and_crop",
                                  "scale_shortside_and_crop", "none",
                                  "fixed"])
def test_transforms_match_jax(mode):
    """Every preprocess mode's geometry and the flip, on one photo."""
    import random
    from PIL import Image
    from cocosnet_tpu.data import transforms as JT
    rs = np.random.RandomState(0)
    img = Image.fromarray(rs.randint(0, 255, (50, 70, 3), dtype=np.uint8))
    kw = dict(preprocess_mode=mode, load_size=48, crop_size=40,
              aspect_ratio=1.25)
    jopt, topt = JCFG.test_defaults(**kw), TCFG.test_defaults(**kw)
    for seed in range(4):
        pj = JT.get_params(jopt, img.size, random.Random(seed))
        pt = TT.get_params(topt, img.size, random.Random(seed))
        assert pj == pt
        assert np.array_equal(TT.image_to_tensor(topt, img, pt),
                              JT.image_to_tensor(jopt, img, pj))


def test_a_label_without_its_photo_is_refused(tmp_path):
    """The pairing check raises (it is no assert, which -O would drop)."""
    root = str(tmp_path / "ade")
    SYN.make_ade20k_tree(root, n_train=3, n_val=2, size=(64, 64),
                         n_classes=13, block=8)
    os.remove(os.path.join(root, "training", "ADE_train_00000002.jpg"))
    opt = TCFG.parse_options(_argv("ade20k", root, True, 0), is_train=True)
    with pytest.raises(ValueError, match="does not look right"):
        TLD.create_dataloader(opt)
    TLD.create_dataloader(opt.replace(no_pairing_check=True))


def test_synthetic_command_line_writes_the_seed_0_tree(tmp_path, capsys):
    """The module's command line writes the tree of make_ade20k_tree's
    defaults (ADE20k's 151 classes, seed 0), file for file."""
    a, b = str(tmp_path / "cli"), str(tmp_path / "fn")
    SYN.main([a, "--train", "2", "--val", "1"])
    assert "synthetic ADE20k tree" in capsys.readouterr().out
    SYN.make_ade20k_tree(b, n_train=2, n_val=1)
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 2 * 3 + 2
    for f in files:
        with open(os.path.join(a, f), "rb") as x, \
                open(os.path.join(b, f), "rb") as y:
            assert x.read() == y.read(), f
