# ------------------------------------------------------------------
"""Configuration for the PyTorch/CUDA port.

The port's own copy of idee_tpu/config.py: the same flat dataclass with the
same field names (which mirror the reference argparse flags 1:1), so config
JSON snapshots written by either package load unchanged in the other.
``read_arguments`` provides the same CLI shim including the ``config.txt``
/ ``config.pkl`` / ``config.json`` experiment snapshot.

The port reads the mesh fields as data parallelism over the ``data``
axis and H sharded over the ``space`` axis (parallel/mesh.py,
parallel/spatial.py); fused_chunk, which only the TPU programs read, is
kept so snapshots round-trip.
"""
# ------------------------------------------------------------------

from __future__ import annotations

import argparse
import ast
import dataclasses
import datetime
import json
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple

# ------------------------------------------------------------------

SYNTHETIC_VARIABLES = ["var_01", "var_02", "var_03", "var_04", "var_05", "var_06"]
CERRA_VARIABLES = ["wdir10", "si10", "al", "hcc", "lcc", "msl"]
ERA5_LAND_VARIABLES = ["d2m", "t2m", "fal", "sp", "e", "tp", "skt", "stl1", "swvl1"]

# CORDEX region grid extents (y, x) (reference: dataset/ERA5_Land_dataset.py:154-160)
CORDEX_REGIONS = {
    "EUR-11": (412, 424),
    "AFR-11": (804, 776),
    "NAM-11": (520, 620),
    "SAM-11": (668, 584),
    "CAS-11": (400, 612),
    "EAS-11": (668, 812),
}


@dataclass
class Config:
    """Flat experiment configuration (field names == reference flags)."""

    # --- general options (reference: config.py:21-46) ---
    seed: int = 0
    n_workers: int = 8
    pin_memory: bool = True
    batch_size: int = 1
    name: str = "test"
    dir_log: str = "./log"

    root_CERRA: str = "../CERRA"
    root_NOAA_CERRA: str = "../NOAA_CERRA"
    root_ERA5_Land: str = "../ERA5-Land"
    root_NOAA: str = "../NOAA_CORDEX"
    root_synthetic: str = "../Synthetic/synthetic_CERRA"

    encoder: str = "Mamba"
    classifier: str = "CNN_3D"
    codebook: str = "LFQ"

    gpu_id: str = "0"  # kept for config-file compatibility; unused
    nan_fill: float = 0.0

    # --- encoder (reference: config.py:49-62) ---
    in_channels_dynamic: int = 6
    in_channels: int = 2  # 2 for ERA5/CERRA (mean,std), 1 for synthetic
    en_embed_dim: List[int] = field(default_factory=lambda: [16, 16])
    en_depths: List[int] = field(default_factory=lambda: [2, 1])
    en_patch_size: Tuple[int, int, int] = (1, 1, 1)
    en_window_size: List[Tuple[int, int, int]] = field(
        default_factory=lambda: [(2, 4, 4), (8, 1, 1)]
    )
    en_mlp_ratio: float = 4.0
    en_drop_rate: float = 0.0
    en_drop_path_rate: float = 0.0
    en_patch_norm: bool = False
    en_use_checkpoint: bool = False

    # encoder Swin (reference: config.py:65-70)
    en_n_heads: List[int] = field(default_factory=lambda: [2, 2])
    en_attn_drop_rate: float = 0.0
    en_qkv_bias: bool = True
    en_qk_scale: Optional[float] = None

    # encoder Mamba (reference: config.py:73-77)
    d_state: List[int] = field(default_factory=lambda: [1, 1])
    d_conv: List[int] = field(default_factory=lambda: [3, 3])
    expand: List[int] = field(default_factory=lambda: [1, 1])
    dt_min: float = 0.01
    dt_max: float = 0.1

    # --- vector quantization (reference: config.py:80-81) ---
    codebook_size: int = 2
    codebook_dim: int = 16

    # --- classifier (reference: config.py:84-85) ---
    cls_dim: int = 16
    cls_drop_rate: float = 0.0

    en_de_pretrained: Optional[str] = None

    # --- splits (reference: config.py:90-96) ---
    years_train: List[str] = field(
        default_factory=lambda: [str(y) for y in range(1984, 2018)]
    )
    years_val: List[str] = field(default_factory=lambda: ["2018", "2019", "2020"])
    years_test: List[str] = field(
        default_factory=lambda: ["2021", "2022", "2023", "2024"]
    )
    times_train: Tuple[int, int] = (1, 52 * 34)
    times_val: Tuple[int, int] = (52 * 34 + 1, 52 * 40)
    times_test: Tuple[int, int] = (52 * 40 + 1, 52 * 46)

    delta_t: int = 8
    window_size: int = 1  # resolution-reduction factor for the data

    threshold: float = 26.0  # VHI threshold
    alpha: float = 0.5  # alpha to compute VHI

    region: str = "EUR-11"
    x_min: int = 0
    x_max: int = 200
    y_min: int = 0
    y_max: int = 200

    # --- training (reference: config.py:110-132) ---
    is_shuffle: bool = False
    is_aug: bool = True
    is_norm: bool = True
    is_clima_scale: bool = True
    n_epochs: int = 100
    optimizer: str = "Adam"
    lr: float = 1e-3
    weight_decay: float = 0.003
    beta1: float = 0.9
    beta2: float = 0.999

    # minGPT-style decay/no-decay parameter groups (the reference defines
    # get_optimizer_groups but ships with it commented out,
    # utils/utils_train.py:73-140, train_synthetic.py:124-125 -- so the
    # parity default here is False)
    use_optimizer_groups: bool = False

    lr_scheduler: str = "cosine"
    lr_warmup: float = 1e-6
    lr_warmup_epochs: int = 2
    lr_min: float = 1e-5
    lr_decay_step: int = 20
    lr_decay_rate: float = 0.9

    lambda_ortho: float = 10.0
    lambda_commitment: float = 3.0
    lambda_anomaly: float = 100.0
    lambda_entropy: float = 0.1
    diversity_gamma: float = 0.1

    # input variables (reference: config.py:135-188)
    variables: List[str] = field(default_factory=lambda: list(CERRA_VARIABLES))
    variables_static: List[str] = field(
        default_factory=lambda: ["latitude", "longitude"]
    )

    phase: str = "train"

    # --- additions of the JAX package (not in the reference) ---
    # Their meaning is documented in idee_tpu/config.py. The port takes a
    # mesh of the "data" axis, or "data" x "space" (mesh_shape [N] or
    # [D, S] under torchrun, parallel/mesh.py; the space axis with either
    # loader and the fused epochs) and leaves fused_chunk unread: JAX
    # cuts a fused epoch into dispatches of fused_chunk steps for the TPU
    # worker's watchdog, which has no counterpart here (a fused epoch is
    # one replay of its CUDA graph per step, train/steps.py::FusedEpoch).
    grid_override: Optional[Tuple[int, int]] = None
    # compute dtype: "float32", or "bfloat16" (parameters, the quantizer,
    # the scans and the losses stay float32; models/vq_model.py)
    dtype: str = "float32"
    mesh_shape: Optional[List[int]] = None
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])
    log_every: int = 50
    codebook_sync_axis: Optional[str] = None
    ckpt_keep: int = 3
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    device_data: bool = False
    fused_epoch: bool = True
    fused_chunk: int = 16
    cache_root: Optional[str] = None
    loader_workers: int = 0
    # freeze the LFQ output projection (default OFF = reference behavior)
    codebook_freeze_out: bool = False
    # weight init: "reference" = Normal(mean=.02, std=.02) over every
    # Conv/Linear (reference models/build.py:110), "zero_mean" =
    # trunc_normal(std=.02), "lecun" = per-module fan-in scaled normals
    init_scheme: str = "reference"
    # anomaly-L1 curriculum (0/0 = reference behavior, L1 always on)
    anomaly_warmup_epochs: int = 0
    anomaly_ramp_epochs: int = 0
    # LFQ entropy-loss softmax sharpness (reference hard-codes 100)
    codebook_inv_temperature: float = 100.0
    # BCE class weighting: "reference" = log((hist/total)^-0.5 + 1.1)
    # (reference models/losses.py:115-118); "capped" = min(1/frac,
    # bce_weight_cap); "focal" = alpha-balanced focal BCE with
    # gamma=bce_focal_gamma
    bce_weighting: str = "reference"
    bce_weight_cap: float = 100.0
    bce_focal_gamma: float = 2.0
    # VQ codebook-variant knobs (reference VQ.py:736-772 kwargs)
    vq_ema_update: bool = False
    vq_decay: float = 0.8
    vq_kmeans_init: bool = False
    vq_kmeans_iters: int = 10
    vq_threshold_ema_dead_code: float = 0.0
    vq_use_cosine_sim: bool = False

    # ------------------------------------------------------------------

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @property
    def log_dir(self) -> str:
        return os.path.join(self.dir_log, self.name)


# ------------------------------------------------------------------
# CLI shim


def _parse_value(text: str, default: Any) -> Any:
    """Parse a CLI string into the type of ``default`` (lists/tuples via
    python literals, bools via truthy strings)."""
    if isinstance(default, bool):
        return text.lower() in ("1", "true", "yes", "y")
    if isinstance(default, (list, tuple)) or default is None:
        try:
            val = ast.literal_eval(text)
            if isinstance(default, tuple) and isinstance(val, list):
                val = tuple(val)
            return val
        except (ValueError, SyntaxError):
            if isinstance(default, (list, tuple)):
                return type(default)(s for s in text.split(",") if s)
            return text
    return type(default)(text)


def build_parser(defaults: Optional[Config] = None) -> argparse.ArgumentParser:
    """Flags are generated from the defaults' dataclass, so Config
    subclasses (the baseline configs) expose their extra fields too."""
    defaults = defaults or Config()
    parser = argparse.ArgumentParser(description="IDEE (PyTorch/CUDA)")
    for f in dataclasses.fields(type(defaults)):
        dv = getattr(defaults, f.name)
        parser.add_argument(f"--{f.name}", type=str, default=None, help=str(f.type))
    parser.add_argument("--config_json", type=str, default=None,
                        help="path to a JSON file with config overrides")
    return parser


def read_arguments(
    train: bool = True,
    print_: bool = True,
    save: bool = True,
    argv: Optional[Sequence[str]] = None,
    defaults: Optional[Config] = None,
) -> Config:
    """Parse CLI args into a Config (reference: config.py:192-203)."""
    defaults = defaults or Config()
    cls = type(defaults)
    parser = build_parser(defaults)
    ns = parser.parse_args(argv)

    cfg_dict = defaults.to_dict()
    if ns.config_json:
        with open(ns.config_json) as fh:
            cfg_dict.update(json.load(fh))
    for f in dataclasses.fields(cls):
        raw = getattr(ns, f.name)
        if raw is not None:
            cfg_dict[f.name] = _parse_value(raw, getattr(defaults, f.name))

    cfg = cls.from_dict(cfg_dict)
    cfg = cfg.replace(phase="train" if train else "test")

    if print_:
        print(format_options(cfg))
    if save:
        save_options(cfg)
    return cfg


def format_options(cfg: Config) -> str:
    """Render the config snapshot (reference: config.py:251-282)."""
    skip = {"variables", "years_train", "years_val", "years_test", "dir_log",
            "root_CERRA", "root_NOAA"}
    msg = "----------------- Options ---------------       -------------------\n\n"
    d = cfg.to_dict()
    for k in sorted(d):
        if k in skip:
            continue
        msg += "{:>25}: {:<20}\n".format(str(k), str(d[k]))
    msg += "\n{:>25}: {:<20}\n".format("root_CERRA", str(cfg.root_CERRA))
    msg += "\n{:>25}: {:<20}\n".format("root_NOAA", str(cfg.root_NOAA))
    msg += "{:>25}: {:<20}\n".format("dir_log", str(cfg.dir_log))
    msg += "\n----------------- Input Variables -------      -------------------"
    msg += "\n\n{}\n".format(str(cfg.variables))
    msg += "\n----------------- Years -----------------      -------------------"
    if cfg.phase == "train":
        msg += "\n\nTraining: {}".format(str(cfg.years_train))
        msg += "\nValidation: {}\n".format(str(cfg.years_val))
    else:
        msg += "\n\nTesting: {}\n".format(str(cfg.years_test))
    msg += "\n----------------- End -------------------      -------------------"
    return msg


def save_options(cfg: Config) -> None:
    """Persist config.txt + config.pkl + config.json under log/<name>/
    (reference: config.py:206-248; JSON added for pickle-free reload)."""
    if not cfg.name:
        cfg = cfg.replace(
            name=str(datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S"))
        )
    os.makedirs(cfg.log_dir, exist_ok=True)
    with open(os.path.join(cfg.log_dir, "config.txt"), "wt") as fh:
        fh.write(format_options(cfg))
    with open(os.path.join(cfg.log_dir, "config.pkl"), "wb") as fh:
        pickle.dump(cfg, fh)
    with open(os.path.join(cfg.log_dir, "config.json"), "wt") as fh:
        json.dump(cfg.to_dict(), fh, indent=2, default=str)


def load_config(path: str) -> Config:
    """Load a Config from a .json snapshot (written by either package) or a
    .pkl snapshot written by this package's save_options."""
    if path.endswith(".json"):
        with open(path) as fh:
            return Config.from_dict(json.load(fh))
    with open(path, "rb") as fh:
        obj = pickle.load(fh)
    if isinstance(obj, Config):
        return obj
    # tolerate reference argparse.Namespace pickles
    return Config.from_dict(vars(obj))


def synthetic_config(**overrides) -> Config:
    """Config preset for the synthetic benchmark (1-channel var_01..06)."""
    base = dict(
        variables=list(SYNTHETIC_VARIABLES),
        in_channels=1,
        encoder="CNN_3D",
    )
    base.update(overrides)
    return Config(**base)
