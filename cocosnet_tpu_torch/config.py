"""Typed, immutable configuration: the port's own copy of cocosnet_tpu's
`Options` (same field names and defaults, so one set of flags configures
both packages), with `finalize` and `test_defaults`. CLI parsing is not
ported yet.
"""

from __future__ import annotations

import dataclasses
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


def finalize(opt: Options) -> Options:
    """Derive semantic_nc (label classes plus the don't-care class) and the
    correspondence downscale factor."""
    semantic_nc = opt.label_nc + (1 if opt.contain_dontcare_label else 0)
    down = 2 if opt.warp_stride == 2 else 4
    return opt.replace(semantic_nc=semantic_nc, down=down)


def test_defaults(**kw) -> Options:
    """Convenience constructor for tests and scripts."""
    return finalize(Options(**kw))
