"""Typed, immutable configuration: the port's own copy of cocosnet_tpu's
`Options` (same field names and defaults, so one set of flags configures
both packages) and of its command-line parser: one flag per field, named
as in the reference CLI, parsed in three stages (the dataset's defaults,
then the saved opt.json under --load_from_opt_file, then the explicit
flags, which win), with `save_options` / `load_options` for opt.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from dataclasses import dataclass


@dataclass(frozen=True)
class Options:
    # ---- experiment specifics ----
    name: str = "label2coco"
    gpu_ids: str = "0"
    checkpoints_dir: str = "./checkpoints"
    model: str = "pix2pix"
    norm_G: str = "spectralspadesyncbatch3x3"
    norm_D: str = "spectralinstance"
    norm_E: str = "spectralinstance"
    phase: str = "train"

    # ---- input/output sizes ----
    batchSize: int = 4
    preprocess_mode: str = "resize_and_crop"
    load_size: int = 256
    crop_size: int = 256
    aspect_ratio: float = 1.0
    label_nc: int = 182
    contain_dontcare_label: bool = False
    output_nc: int = 3

    # ---- data ----
    dataroot: str = "./datasets/ade20k"
    dataset_mode: str = "ade20k"
    serial_batches: bool = False
    no_flip: bool = False
    nThreads: int = 4
    max_dataset_size: int = sys.maxsize
    load_from_opt_file: bool = False
    cache_filelist_write: bool = False
    cache_filelist_read: bool = False
    display_winsize: int = 256

    # ---- generator ----
    netG: str = "spade"
    ngf: int = 64
    init_type: str = "xavier"
    init_variance: float = 0.02
    z_dim: int = 256

    # ---- CoCosNet-specific ----
    CBN_intype: str = "warp_mask"
    maskmix: bool = False
    use_attention: bool = False
    warp_mask_losstype: str = "none"   # none | direct | cycle
    show_warpmask: bool = False
    match_kernel: int = 3
    adaptor_kernel: int = 3
    PONO: bool = False
    PONO_C: bool = False
    eqlr_sn: bool = False
    vgg_normal_correct: bool = False
    weight_domainC: float = 0.0
    domain_rela: bool = False
    use_ema: bool = False
    ema_beta: float = 0.999
    warp_cycle_w: float = 0.0
    two_cycle: bool = False
    apex: bool = False
    warp_bilinear: bool = False
    adaptor_res_deeper: bool = False
    adaptor_nonlocal: bool = False
    adaptor_se: bool = False
    dilation_conv: bool = False
    use_coordconv: bool = False
    warp_patch: bool = False
    warp_stride: int = 4
    mask_noise: bool = False
    noise_for_mask: bool = False
    video_like: bool = False

    # ---- discriminator ----
    netD: str = "multiscale"
    netD_subarch: str = "n_layer"
    num_D: int = 2
    n_layers_D: int = 4
    ndf: int = 64

    # ---- train schedule / optimizer ----
    display_freq: int = 2000
    print_freq: int = 100
    save_latest_freq: int = 5000
    save_epoch_freq: int = 10
    continue_train: bool = False
    which_epoch: str = "latest"
    niter: int = 100
    niter_decay: int = 100
    optimizer: str = "adam"
    beta1: float = 0.5
    beta2: float = 0.999
    lr: float = 0.0002
    D_steps_per_G: int = 1

    # ---- loss weights ----
    lambda_feat: float = 10.0
    lambda_vgg: float = 10.0
    no_ganFeat_loss: bool = False
    gan_mode: str = "hinge"
    no_TTUR: bool = False
    which_perceptual: str = "5_2"
    weight_perceptual: float = 0.01
    weight_mask: float = 0.0
    real_reference_probability: float = 0.7
    hard_reference_probability: float = 0.2
    weight_gan: float = 10.0
    novgg_featpair: float = 10.0
    D_cam: float = 0.0
    warp_self_w: float = 0.0
    fm_ratio: float = 0.1
    use_22ctx: bool = False
    ctx_w: float = 1.0
    mask_epoch: int = -1

    # ---- test ----
    how_many: int = sys.maxsize
    show_corr: bool = False
    save_per_img: bool = False

    # ---- dataset extras ----
    no_pairing_check: bool = False

    # ---- extensions of the JAX package, kept so flags carry over ----
    isTrain: bool = True
    platform: str = ""
    compute_dtype: str = "bf16"        # bf16 | f32, read with the policy
    use_pallas: bool = True
    mesh_data: int = 0
    mesh_model: int = 1
    ref_table_dir: str = "./data"
    vgg_weights: str = "./assets/vgg19_conv.npz"
    seed: int = 0
    output_dir: str = "./output"
    log_compiles: bool = False
    allow_random_weights: bool = False
    profile_dir: str = ""
    remat: bool = False
    remat_full: bool = False
    remat_policy: str = "conv_small"
    steps_per_dispatch: int = 1
    distributed: bool = False
    coordinator_address: str = ""
    num_processes: int = -1
    process_id: int = -1
    dist_timeout_s: int = 900

    # ---- derived (set in finalize) ----
    semantic_nc: int = 0
    epoch: int = 1
    down: int = 4                      # correspondence downscale

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)

    @property
    def feature_hw(self) -> int:
        return self.crop_size // self.down

    @property
    def corr_n(self) -> int:
        hw = self.feature_hw
        return hw * hw


# Per-dataset defaults, each dataset's modify_commandline_options
_DATASET_DEFAULTS = {
    # ade20k_dataset.py:12-25
    "ade20k": dict(preprocess_mode="resize_and_crop", crop_size=256,
                   display_winsize=256, label_nc=150, contain_dontcare_label=True),
    # celebahq_dataset.py:14-29
    "celebahq": dict(preprocess_mode="resize_and_crop", crop_size=256,
                     display_winsize=256, label_nc=19, contain_dontcare_label=False,
                     no_pairing_check=True),
    # celebahqedge_dataset.py:15-30
    "celebahqedge": dict(preprocess_mode="resize_and_crop", crop_size=256,
                         display_winsize=256, label_nc=15, contain_dontcare_label=False,
                         no_pairing_check=True),
    # deepfashion_dataset.py:16-31
    "deepfashion": dict(preprocess_mode="resize_and_crop", crop_size=256,
                        display_winsize=256, label_nc=20, contain_dontcare_label=False,
                        no_pairing_check=True),
    # flickr_dataset.py:9-23
    "flickr": dict(preprocess_mode="resize_and_crop", crop_size=256,
                   display_winsize=256, label_nc=150, contain_dontcare_label=True),
}

_FIELD_NAMES = {f.name for f in dataclasses.fields(Options)}
_BOOL_FIELDS = {f.name for f in dataclasses.fields(Options) if f.type in ("bool", bool)}
# derived fields, and what --load_from_opt_file does not take from opt.json
_DERIVED = ("isTrain", "semantic_nc", "epoch", "down")
_NOT_LOADED = _DERIVED + ("phase", "load_from_opt_file", "continue_train",
                          "which_epoch")


def build_parser(is_train: bool) -> argparse.ArgumentParser:
    """argparse parser with one flag per Options field, reference-compatible
    names; booleans are store_true flags, as in the reference."""
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter, allow_abbrev=False)
    for f in dataclasses.fields(Options):
        if f.name in _DERIVED:
            continue
        flag = "--" + f.name
        if f.name in _BOOL_FIELDS:
            p.add_argument(flag, action="store_true", default=f.default)
        elif f.type in ("int", int):
            p.add_argument(flag, type=int, default=f.default)
        elif f.type in ("float", float):
            p.add_argument(flag, type=float, default=f.default)
        else:
            p.add_argument(flag, type=str, default=f.default)
    return p


def _apply_phase_defaults(ns: argparse.Namespace, is_train: bool,
                          explicitly_set: set) -> None:
    """load_size defaults to 286 (train) / 256 (test) for every dataset
    (e.g. ade20k_dataset.py:15-19); the test phase forces serial batches,
    no flip and a 256 crop unless given (test_options.py:16-21)."""
    if "load_size" not in explicitly_set:
        ns.load_size = 286 if is_train else 256
    if not is_train:
        ns.serial_batches = True
        ns.no_flip = True
        ns.phase = "test"
        if "crop_size" not in explicitly_set:
            ns.crop_size = 256
        if "display_winsize" not in explicitly_set:
            ns.display_winsize = 256


def parse_options(argv=None, is_train: bool = True) -> Options:
    """Options from `argv` (sys.argv[1:] when None) for the train or the
    test phase (base_options.py:97-126's three-stage parse)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    explicitly_set = {a.lstrip("-").split("=")[0] for a in argv if a.startswith("--")}

    parser = build_parser(is_train)
    pre, _ = parser.parse_known_args(argv)
    for k, v in _DATASET_DEFAULTS.get(pre.dataset_mode, {}).items():
        parser.set_defaults(**{k: v})
    if pre.load_from_opt_file:
        # base_options.py:119-122,160-166: saved options become the defaults
        saved = load_options(os.path.join(pre.checkpoints_dir, pre.name,
                                          "opt.json"))
        for k in _FIELD_NAMES - set(_NOT_LOADED):
            parser.set_defaults(**{k: getattr(saved, k)})
    ns = parser.parse_args(argv)
    _apply_phase_defaults(ns, is_train, explicitly_set)

    d = vars(ns)
    d["isTrain"] = is_train
    d["phase"] = "train" if is_train else "test"
    return finalize(Options(**{k: v for k, v in d.items() if k in _FIELD_NAMES}))


def save_options(opt: Options, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(opt), f, indent=2, default=str)


def load_options(path: str) -> Options:
    with open(path) as f:
        d = json.load(f)
    d = {k: v for k, v in d.items() if k in _FIELD_NAMES}
    if d.get("max_dataset_size") is None:
        d["max_dataset_size"] = sys.maxsize
    return finalize(Options(**d))


def finalize(opt: Options) -> Options:
    """Derive semantic_nc (label classes plus the don't-care class) and the
    correspondence downscale factor."""
    semantic_nc = opt.label_nc + (1 if opt.contain_dontcare_label else 0)
    down = 2 if opt.warp_stride == 2 else 4
    return opt.replace(semantic_nc=semantic_nc, down=down)


def test_defaults(**kw) -> Options:
    """Convenience constructor for tests and scripts."""
    return finalize(Options(**kw))
