"""The port's option parser against the JAX package's: the same argv lists
(the published command lines of tests/test_config.py) parse to the same
options, field by field, in both phases, also through
--load_from_opt_file, and opt.json written by either package reads back
in the other."""

import dataclasses

import pytest

from cocosnet_tpu import config as JCFG
from cocosnet_tpu_torch import config as TCFG
from test_torch_threads import torch_threads  # noqa: F401

ARGVS = {
    "ade20k_inference": (
        "--name ade20k --dataset_mode ade20k --dataroot ./imgs/ade20k "
        "--gpu_ids 0 --nThreads 0 --batchSize 6 --use_attention --maskmix "
        "--warp_mask_losstype direct --PONO --PONO_C"),
    "deepfashion_inference": (
        "--name deepfashion --dataset_mode deepfashion "
        "--dataroot ./imgs/DeepFashion --batchSize 4 --use_attention "
        "--PONO --PONO_C --warp_bilinear --no_flip --warp_patch "
        "--video_like --adaptor_kernel 4"),
    "ade20k_train": (
        "--name ade20k --dataset_mode ade20k --dataroot d --niter 100 "
        "--niter_decay 100 --use_attention --maskmix "
        "--warp_mask_losstype direct --weight_mask 100.0 --PONO --PONO_C "
        "--batchSize 32 --vgg_normal_correct"),
    "celebahq_train": (
        "--dataset_mode celebahq --dataroot d --which_perceptual 4_2 "
        "--weight_perceptual 0.001 --fm_ratio 1.0 --warp_bilinear "
        "--warp_cycle_w 0.1"),
    "explicit_label_nc": "--dataset_mode ade20k --dataroot d --label_nc 99",
    "warp_stride_2": "--dataset_mode ade20k --dataroot d --warp_stride 2",
    "celebahqedge": "--dataset_mode celebahqedge --dataroot d --warp_bilinear",
    "flickr_sizes": ("--dataset_mode flickr --dataroot d --crop_size 64 "
                     "--load_size=72 --display_winsize 128 --lr 1e-4"),
    "defaults": "",
}


def _fields(opt):
    return dataclasses.asdict(opt)


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("name", list(ARGVS))
def test_parse_options_matches_jax(name, is_train):
    argv = ARGVS[name].split()
    want = _fields(JCFG.parse_options(argv, is_train=is_train))
    got = _fields(TCFG.parse_options(argv, is_train=is_train))
    assert got.keys() == want.keys()
    assert [k for k in want if got[k] != want[k]] == []


def test_the_parsers_have_the_same_flags():
    def flags(parser):
        return {a.dest: (a.default, a.type, a.const)
                for a in parser._actions if a.dest != "help"}
    for is_train in (True, False):
        assert flags(TCFG.build_parser(is_train)) == \
            flags(JCFG.build_parser(is_train))


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_from_opt_file_matches_jax(tmp_path, writer, is_train):
    """opt.json (written by either package) becomes the defaults; the
    dataset's defaults come under it and explicit flags win over both."""
    saved = JCFG.parse_options(ARGVS["ade20k_train"].split() + [
        "--checkpoints_dir", str(tmp_path), "--label_nc", "40",
        "--ngf", "32", "--which_epoch", "7"], is_train=True)
    path = str(tmp_path / "ade20k" / "opt.json")
    if writer == "jax":
        JCFG.save_options(saved, path)
    else:
        TCFG.save_options(TCFG.Options(**_fields(saved)), path)
    argv = ["--name", "ade20k", "--checkpoints_dir", str(tmp_path),
            "--load_from_opt_file", "--ngf", "16", "--continue_train"]
    want = JCFG.parse_options(argv, is_train=is_train)
    got = TCFG.parse_options(argv, is_train=is_train)
    assert _fields(got) == _fields(want)
    assert got.label_nc == 40 and got.ngf == 16 and got.which_epoch == "latest"
    assert got.use_attention and got.weight_mask == 100.0


@pytest.mark.parametrize("name", ["ade20k_inference", "celebahqedge"])
def test_options_roundtrip_across_packages(tmp_path, name):
    opt = TCFG.parse_options(ARGVS[name].split(), is_train=False)
    TCFG.save_options(opt, str(tmp_path / "port.json"))
    assert TCFG.load_options(str(tmp_path / "port.json")) == opt
    assert _fields(JCFG.load_options(str(tmp_path / "port.json"))) == \
        _fields(opt)
    JCFG.save_options(JCFG.parse_options(ARGVS[name].split(),
                                         is_train=False),
                      str(tmp_path / "jax.json"))
    assert TCFG.load_options(str(tmp_path / "jax.json")) == opt
