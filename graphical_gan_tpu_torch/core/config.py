"""Config layer of the port: a copy of ``graphical_gan_tpu/core/config.py``
(``DataSpec``, ``GanInferenceConfig``, ``GMGanConfig``, ``SSGanConfig``,
the ``derive_*`` rules and the per-dataset defaults), kept here so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# mode families -------------------------------------------------------------

VEGAN_DIVERGENCE_MODES = ("vegan-mmd", "vegan-kl", "vegan-ikl", "vegan-jsd", "vae")
VEGAN_CODE_MODES = ("vegan", "vegan-wgan-gp")
REC_MODES = (
    "alice", "alice-z", "alice-x", "vegan", "vegan-wgan-gp",
    "vegan-kl", "vegan-ikl", "vegan-jsd", "vegan-mmd", "local_epce",
)


def derive_critic_iters(mode: str) -> int:
    """``gan_inference_mnist.py:46-51``."""
    if mode in VEGAN_DIVERGENCE_MODES:
        return 0
    if mode in ("vegan", "vegan-wgan-gp", "wali", "wali-gp"):
        return 5
    return 1


def derive_type_q(mode: str) -> Tuple[str, str]:
    """(TYPE_Q, TYPE_P) — ``gan_inference_mnist.py:32-41``."""
    if mode in ("vegan-kl", "vegan-ikl", "vegan-jsd"):
        return "learn_std", "no_std"
    if mode == "vae":
        return "learn_std", "learn_std"
    return "no_std", "no_std"


def derive_bn_latent(mode: str, bn_default: bool, dim_latent_default: int
                     ) -> Tuple[bool, int]:
    """``gan_inference_mnist.py:64-69`` — vegan family shrinks z and drops BN."""
    if mode in ("vegan", "vegan-wgan-gp", "vegan-kl", "vegan-jsd", "vegan-ikl"):
        return False, 8
    return bn_default, dim_latent_default


def derive_beta1(mode: str) -> float:
    """``gan_inference_mnist.py:56-59``."""
    return 0.9 if mode == "vae" else 0.5


@dataclass(frozen=True)
class DataSpec:
    """Shapes + normalization conventions of a dataset, per reference."""
    name: str
    image_hw: Tuple[int, int]
    channels: int
    # how raw loader output maps to network input:
    #   'unit'   — already float in [0,1]                  (mnist)
    #   'int_pm1'— int pixels -> 2*(x/255 - .5) in [-1,1]  (cifar10/svhn :262)
    #   'dequant'— int pixels -> 2*(x/256 - .5)+U(0,1/128) (celebA, face.py:155-157)
    #   'unit_pm1'— float [0,1] -> 2*(x-.5)                (moving-mnist, ssgan:514)
    #   'int256_pm1'— int pixels -> 2*(x/256 - .5)         (chairs, ssgan_chairs:508)
    normalization: str = "unit"

    @property
    def output_dim(self) -> int:
        return self.image_hw[0] * self.image_hw[1] * self.channels


MNIST = DataSpec("mnist", (28, 28), 1, "unit")
CIFAR10 = DataSpec("cifar10", (32, 32), 3, "int_pm1")
SVHN = DataSpec("svhn", (32, 32), 3, "int_pm1")
CELEBA = DataSpec("celeba", (64, 64), 3, "dequant")
MOVING_MNIST = DataSpec("moving_mnist", (64, 64), 1, "unit_pm1")
CHAIRS = DataSpec("chairs", (64, 64), 3, "int256_pm1")

_DATASETS = {d.name: d for d in
             (MNIST, CIFAR10, SVHN, CELEBA, MOVING_MNIST, CHAIRS)}


def dataset_spec(name: str) -> DataSpec:
    return _DATASETS[name]


# ---------------------------------------------------------------------------
# family 1 — GAN inference (ALI et al.):  gan_inference_{mnist,cifar10,svhn,face}
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GanInferenceConfig:
    dataset: str = "mnist"
    mode: str = "ali"
    batch_size: int = 50
    dim: int = 64              # DIM (mnist/cifar/svhn); face uses dim_g/dim_d
    dim_g: Optional[int] = None
    dim_d: Optional[int] = None
    dim_latent: int = 128
    bn: bool = True
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    iters: int = 200_000
    lambda_: float = 1.0       # LAMBDA
    distance_x: str = "l2"
    std: float = 0.1           # STD for fix_std
    z_samples: int = 100       # MC samples for vegan-{kl,ikl,jsd}
    dropout_rate: float = 0.2  # DR_RATE (cifar) — identity at train time, see ops.dropout
    critic_iters: int = 1
    type_q: str = "no_std"
    type_p: str = "no_std"
    gp_lambda: float = 10.0
    decay: bool = False        # linear LR decay (face only)
    n_vis: int = 100
    # numerics: activations in compute_dtype; params and statistics in f32
    compute_dtype: str = "float32"   # or 'bfloat16'
    # training-side fields, kept so a config.json of the JAX package loads
    # field for field; serving reads none of them
    param_dtype: str = "float32"     # 'bfloat16' => f32 masters in opt state
    moment_dtype: str = "float32"    # dtype of the Adam moments
    remat: bool = False              # recompute the forward in the backward
    accum_steps: int = 1             # microbatches per optimizer update
    fused_gp: bool = False           # one batched D apply for the wali-gp GP

    @property
    def data(self) -> DataSpec:
        return dataset_spec(self.dataset)

    @property
    def has_discriminator(self) -> bool:
        return self.mode not in VEGAN_DIVERGENCE_MODES

    @property
    def has_rec_penalty(self) -> bool:
        return self.mode in REC_MODES


GAN_INFERENCE_MODES = (
    "ali", "alice", "alice-z", "alice-x", "vegan", "vegan-wgan-gp",
    "vegan-mmd", "vegan-kl", "vegan-ikl", "vegan-jsd", "vae", "wali",
    "wali-gp",
)


def gan_inference_defaults(dataset: str, mode: str = "ali", **overrides
                           ) -> GanInferenceConfig:
    """Published per-script defaults (gan_inference_{mnist,cifar10,svhn,face})."""
    if mode not in GAN_INFERENCE_MODES:
        raise ValueError(
            f"unknown gan_inference mode {mode!r}; valid modes: "
            f"{', '.join(GAN_INFERENCE_MODES)}")
    type_q, type_p = derive_type_q(mode)
    common = dict(
        dataset=dataset, mode=mode,
        critic_iters=derive_critic_iters(mode),
        beta1=derive_beta1(mode),
        type_q=type_q, type_p=type_p,
    )
    if dataset == "mnist":
        bn, dl = derive_bn_latent(mode, True, 128)
        cfg = dict(batch_size=50, dim=64, bn=bn, dim_latent=dl, n_vis=100)
    elif dataset == "cifar10":
        bn, dl = derive_bn_latent(mode, True, 128)
        cfg = dict(batch_size=64, dim=64, bn=bn, dim_latent=dl, n_vis=128)
    elif dataset == "svhn":
        # svhn script: BN_FLAG=False regardless of mode (diff-verified in survey)
        _, dl = derive_bn_latent(mode, False, 128)
        cfg = dict(batch_size=64, dim=64, bn=False, dim_latent=dl, n_vis=128)
    elif dataset == "celeba":
        # gan_inference_face.py:33-50 — ali only, no BN, 4-deconv nets
        cfg = dict(batch_size=128, dim=32, dim_g=32, dim_d=32, bn=False,
                   dim_latent=128, iters=100_000, n_vis=256)
    else:
        raise ValueError(f"unknown gan_inference dataset {dataset!r}")
    common.update(cfg)
    common.update(overrides)
    return GanInferenceConfig(**common)


# ---------------------------------------------------------------------------
# family 2 — GMGAN (Gaussian-mixture prior): gmgan_inference_*
# ---------------------------------------------------------------------------

GMGAN_MODES = ("ali", "local_ep", "alice", "local_epce", "vegan")
MODE_KS = ("CONCRETE", "STRAIGHT_THROUGHT_CONCRETE", "STRAIGHT_THROUGHT",
           "REINFORCE")


@dataclass(frozen=True)
class GMGanConfig:
    dataset: str = "mnist"
    mode: str = "local_ep"            # ali, local_ep, alice, local_epce, vegan
    mode_k: str = "CONCRETE"          # MODE_KS
    n_coms: int = 30
    temp: float = 0.1                 # Gumbel-softmax temperature
    control_variate: float = 0.0      # REINFORCE baseline
    batch_size: int = 50
    dim: int = 64
    dim_g: Optional[int] = None
    dim_d: Optional[int] = None
    dim_latent: int = 128
    bn: bool = True
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    iters: int = 200_000
    lambda_: float = 1.0
    distance_x: str = "l2"
    dropout_rate: float = 0.2
    critic_iters: int = 1
    type_q: str = "no_std"
    type_p: str = "no_std"
    n_vis: int = 300
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"
    remat: bool = False
    accum_steps: int = 1

    @property
    def data(self) -> DataSpec:
        return dataset_spec(self.dataset)


def gmgan_defaults(dataset: str, mode: str = "local_ep", **overrides
                   ) -> GMGanConfig:
    """Published per-script defaults (gmgan_inference_{mnist,svhn,cifar10,
    face}): mnist B=50 with 30 components, svhn B=64, 50, no BN, cifar10
    B=64, 30, celeba B=128, dim 32, 100 components, no BN."""
    if mode not in GMGAN_MODES:
        raise ValueError(f"unknown gmgan mode {mode!r}; valid modes: "
                         f"{', '.join(GMGAN_MODES)}")
    type_q, type_p = derive_type_q(mode)
    common = dict(dataset=dataset, mode=mode,
                  critic_iters=derive_critic_iters(mode),
                  beta1=derive_beta1(mode), type_q=type_q, type_p=type_p)
    if dataset == "mnist":
        bn, dl = derive_bn_latent(mode, True, 128)
        cfg = dict(batch_size=50, dim=64, bn=bn, dim_latent=dl, n_coms=30,
                   n_vis=300)
    elif dataset == "svhn":
        _, dl = derive_bn_latent(mode, False, 128)
        cfg = dict(batch_size=64, dim=64, bn=False, dim_latent=dl, n_coms=50,
                   n_vis=500)
    elif dataset == "cifar10":
        bn, dl = derive_bn_latent(mode, True, 128)
        cfg = dict(batch_size=64, dim=64, bn=bn, dim_latent=dl, n_coms=30,
                   n_vis=300)
    elif dataset == "celeba":
        cfg = dict(batch_size=128, dim=32, dim_g=32, dim_d=32, bn=False,
                   dim_latent=128, n_coms=100, iters=100_000, n_vis=400)
    else:
        raise ValueError(f"unknown gmgan dataset {dataset!r}")
    common.update(cfg)
    common.update(overrides)
    if common.get("mode_k", "CONCRETE") not in MODE_KS:
        raise ValueError(f"unknown MODE_K {common['mode_k']!r}; valid: "
                         f"{', '.join(MODE_KS)}")
    return GMGanConfig(**common)


# ---------------------------------------------------------------------------
# family 3 — SSGAN (state-space / video): ssgan_inference_*
# ---------------------------------------------------------------------------

SSGAN_MODES = ("local_ep", "local_epce-z", "ali", "alice-z")
POS_MODES = ("naive_mean_field", "inverse", "forward_inverse", "gsp")
ALI_MODES = ("concat_x", "concat_z", "3dcnn")


@dataclass(frozen=True)
class SSGanConfig:
    dataset: str = "moving_mnist"
    mode: str = "local_ep"            # SSGAN_MODES
    pos_mode: str = "naive_mean_field"  # POS_MODES
    ali_mode: str = "concat_x"        # ALI_MODES
    op_dyn_mode: str = "res"          # res, res_w
    bn: bool = False
    seq_len: int = 16
    dim_latent_g: int = 128
    dim_latent_l: int = 8
    dim_op: int = 256
    dim: int = 32
    n_classes: int = 10               # 0 => unconditional (chairs)
    channels: int = 1
    image_hw: Tuple[int, int] = (64, 64)
    lambda_: float = 0.1
    lr: float = 1e-4
    batch_size: int = 50
    beta1: float = 0.5
    beta2: float = 0.999
    iters: int = 100_000
    critic_iters: int = 1
    dropout_rate: float = 0.2
    n_vis: int = 50
    compute_dtype: str = "float32"
    param_dtype: str = "float32"
    moment_dtype: str = "float32"
    remat: bool = False
    accum_steps: int = 1

    @property
    def dim_latent_t(self) -> int:
        return self.dim_latent_l

    @property
    def data(self) -> DataSpec:
        # moving-mnist synthesizes float [0,1]; chairs npy carries int pixels
        # (ssgan_inference_chairs.py:508 divides by 256)
        norm = "int256_pm1" if self.dataset == "chairs" else "unit_pm1"
        return DataSpec(self.dataset, tuple(self.image_hw), self.channels,
                        norm)

    @property
    def output_dim(self) -> int:
        return self.image_hw[0] * self.image_hw[1] * self.channels

    @property
    def conditional(self) -> bool:
        return self.n_classes > 0

    @property
    def ratio(self):
        """Discriminator weights (``ssgan_inference_moving_mnist.py:
        78-79``): LEN-1 pair Ds, the z_g D and the frame D weighted LEN,
        normalized."""
        import numpy as np
        r = [1.0] * (self.seq_len - 1) + [1.0, float(self.seq_len)]
        return np.asarray(r) / (len(r) + self.seq_len - 1)


def ssgan_defaults(dataset: str, mode: str = "local_ep", **overrides
                   ) -> SSGanConfig:
    """Published per-script defaults: moving-MNIST LEN 16, conditional on
    10 classes, 1 channel, ``res``, 100k iterations; chairs LEN 31,
    unconditional, 3 channels, ``res_w``, 40k (``ssgan_inference_chairs.
    py``). Both B 50, DIM 32."""
    if mode not in SSGAN_MODES:
        raise ValueError(f"unknown ssgan mode {mode!r}; valid modes: "
                         f"{', '.join(SSGAN_MODES)}")
    if dataset == "moving_mnist":
        cfg = dict(dataset=dataset, mode=mode, seq_len=16, n_classes=10,
                   channels=1, iters=100_000, op_dyn_mode="res")
    elif dataset == "chairs":
        cfg = dict(dataset=dataset, mode=mode, seq_len=31, n_classes=0,
                   channels=3, iters=40_000, op_dyn_mode="res_w")
    else:
        raise ValueError(f"unknown ssgan dataset {dataset!r}")
    cfg.update(overrides)
    out = SSGanConfig(**cfg)
    for name, value, valid in (("pos_mode", out.pos_mode, POS_MODES),
                               ("ali_mode", out.ali_mode, ALI_MODES),
                               ("op_dyn_mode", out.op_dyn_mode,
                                ("res", "res_w"))):
        if value not in valid:
            raise ValueError(f"unknown {name} {value!r}; valid: "
                             f"{', '.join(valid)}")
    return out


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def print_model_settings(locals_: dict, logfile: str = None) -> str:
    """The reference's settings dump (``tflib/__init__.py:100-114``): the
    UPPERCASE names of a namespace, sorted, printed and, with ``logfile``,
    appended to it. Scripts written in the reference's UPPERCASE style keep
    it; the config dataclasses make it mostly unneeded."""
    skip = ("T", "SETTINGS", "ALL_SETTINGS")
    rows = sorted((k, v) for k, v in locals_.items()
                  if k.isupper() and k not in skip)
    lines = ["Uppercase local vars:"]
    lines += [f"\t{k}: {v}" for k, v in rows]
    text = "\n".join(lines)
    print(text)
    if logfile is not None:
        with open(logfile, "a") as f:
            f.write(text + "\n")
    return text


def print_model_settings_dict(settings: dict) -> str:
    """``tflib/__init__.py:116-121``."""
    rows = sorted(settings.items())
    lines = ["Settings dict:"] + [f"\t{k}: {v}" for k, v in rows]
    text = "\n".join(lines)
    print(text)
    return text
