"""Typed experiment configuration.

Replaces the reference's three-layer flag system (run.sh USER SETTINGS +
parse_options.sh overrides + argparse defaults persisted via ``torch.save(args)``
as model.conf — egs/one-to-one/run.sh:13-205, train…py:290) with dataclasses
serialized as JSON. The training stage persists the resolved ``ModelConfig`` as
``model.json``; decode/cvgv reload it as the authoritative model config.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class FeatureConfig:
    """Analysis parameters (reference constants feature_extract_vc.py:36-55)."""

    fs: int = 22050
    shiftms: float = 5.0
    minf0: float = 40.0
    maxf0: float = 700.0
    mcep_dim: int = 49          # mcep order; +1 coeffs incl. c0
    mcep_alpha: float = 0.455   # 22.05 kHz warping
    fftl: int = 1024
    irlen: int = 1024
    highpass_cutoff: float = 70.0
    lowpass_cutoff: float = 20.0
    pow_threshold: float = -20.0
    n_jobs: int = 10


@dataclass
class ModelConfig:
    """Network structure (reference run.sh:133-190, train…py:207-233)."""

    in_dim: int = 54
    out_dim: int = 50
    lat_dim: int = 32
    n_spk: int = 2              # speaker one-hot code dim
    hidden_layers: int = 1
    hidden_units: int = 1024
    kernel_size: int = 3
    dilation_size: int = 2      # = conv "layers"; receptive field kernel**layers
    n_cyc: int = 2
    do_prob: float = 0.5
    stdim: int = 4              # excitation/spectrum split index in feat vec
    posterior: str = "gauss"    # "gauss" | "laplace" (ref gru_vae.py:101-144)
    spk_src: str = "VCC2SF1"
    spk_trg: str = "VCC2TF1"
    # perf knobs (numerics-affecting): use_pallas = the fused AR-GRU
    # kernels (K1-K3, ops/cuda_gru.py; on CPU tensors their plain versions),
    # on by default in the port, where the JAX package defaults to its XLA
    # path; use_pallas=False asks for the plain scan.  compute_dtype =
    # "bfloat16" runs matmuls in bf16 with f32 master weights
    use_pallas: bool = True
    compute_dtype: str = "float32"


@dataclass
class TrainConfig:
    """Optimization schedule (reference run.sh:155-190, train…py:226-239)."""

    lr: float = 1e-4
    weight_decay: float = 0.0
    batch_size: int = 80        # frames per TBPTT segment
    batch_size_utt: int = 5
    batch_size_utt_eval: int = 5
    pad_len: int = 2200
    epoch_count: int = 500
    eval_interval: int = 1      # eval epoch every N training epochs
    seed: int = 1
    resume: Optional[str] = None


@dataclass
class MeshConfig:
    """Device-mesh layout for pjit sharding (no reference counterpart; the
    reference's multi-node story is Kaldi run.pl/slurm.pl shell dispatch)."""

    dp: int = 1                 # data-parallel axis size (utterances/chains/particles)
    axis_names: tuple = ("dp",)


@dataclass
class ExperimentConfig:
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    expdir: str = "exp/default"

    def name(self) -> str:
        """Experiment identity string encoding hyperparameters (run.sh:481 style)."""
        m, t = self.model, self.train
        return (
            f"tpu-cyclevae-{m.posterior}_hl{m.hidden_layers}_hu{m.hidden_units}"
            f"_ld{m.lat_dim}_ks{m.kernel_size}_ds{m.dilation_size}"
            f"_cyc{m.n_cyc}_lr{t.lr:g}_bs{t.batch_size}_bsu{t.batch_size_utt}"
        )


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {k: _to_dict(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return obj


def save_config(cfg: ExperimentConfig, path: str):
    with open(path, "w") as f:
        json.dump(_to_dict(cfg), f, indent=2)


_SUBCONFIGS = {"feature": FeatureConfig, "model": ModelConfig,
               "train": TrainConfig, "mesh": MeshConfig}


def _from_dict(cls, d: Dict[str, Any]):
    kwargs = {}
    for f_ in dataclasses.fields(cls):
        if f_.name not in d:
            continue
        v = d[f_.name]
        sub = _SUBCONFIGS.get(f_.name)
        if sub is not None and isinstance(v, dict):
            v = _from_dict(sub, v)
        if f_.name == "axis_names" and isinstance(v, list):
            v = tuple(v)
        kwargs[f_.name] = v
    return cls(**kwargs)


def load_config(path: str) -> ExperimentConfig:
    with open(path) as f:
        d = json.load(f)
    return _from_dict(ExperimentConfig, d)
