"""Faults planted in the program's Parallel WaveGAN path, each a way its
rendering could break, as ``faults.py`` plants the others (through
``setattr(obj, name, value)``): the CPU tests plant them at a tiny size,
and on the card this file runs ``calibrate.py`` with them added to its
``--fault`` choices:

    python3 benchmark/faults_pwg.py --workload voc-vocode-pwg --seeds 11,12 \\
        --fault pwg_aux_left_out
"""

from __future__ import annotations

import functools
import math
import sys
from pathlib import Path
from typing import Callable, Dict

import torch

Setter = Callable[[object, str, object], None]


def pwg_aux_left_out(setattr: Setter) -> None:
    """The last layer computes its gate without the conditioning: its rows
    of the packed product that read c are zero."""
    from cyclevae_tpu_torch.models import pwg
    real = pwg.pack_layers

    def broken(params, cfg):
        w1, b1, w2, b2 = real(params, cfg)
        w1 = w1.clone()
        k = cfg.kernel_size * cfg.residual_channels
        w1[cfg.layers - 1, k:k + cfg.aux_channels] = 0.0
        return w1, b1, w2, b2

    setattr(pwg, "pack_layers", broken)


def pwg_gate_halves_swapped(setattr: Setter) -> None:
    """g = tanh(a[G/2:]) * sigmoid(a[:G/2]) in every layer: the halves of the
    gate's product and bias exchanged."""
    from cyclevae_tpu_torch.models import pwg
    real = pwg.pack_layers

    def broken(params, cfg):
        w1, b1, w2, b2 = real(params, cfg)
        h = cfg.gate_channels // 2
        swap = lambda t: torch.cat([t[..., h:], t[..., :h]], dim=-1).contiguous()
        return swap(w1), swap(b1), w2, b2

    setattr(pwg, "pack_layers", broken)


def pwg_sqrt_half_dropped(setattr: Setter) -> None:
    """x' = x + W_out g + b_out in every layer, without the sqrt(1/2)."""
    from cyclevae_tpu_torch.ops import cuda_pwg
    real = cuda_pwg.cuda_pwg_layer

    # wraps: the stand-in carries the wrapper's launch count, which the
    # launch adds to under the module's name
    @functools.wraps(real)
    def broken(*a, **k):
        x, skip = real(*a, **k)
        return x * math.sqrt(2.0), skip

    setattr(cuda_pwg, "cuda_pwg_layer", broken)


FAULTS: Dict[str, Callable[[Setter], None]] = {
    f.__name__: f for f in (pwg_aux_left_out, pwg_gate_halves_swapped, pwg_sqrt_half_dropped)}


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import calibrate, faults
    faults.FAULTS.update(FAULTS)
    sys.exit(calibrate.main())
