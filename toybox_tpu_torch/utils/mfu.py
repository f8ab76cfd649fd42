"""Model-FLOPs-utilization accounting (port of toybox_tpu.utils.mfu for
the H100).

``program_flops`` counts the FLOPs of one call of a function with
``torch.utils.flop_counter.FlopCounterMode`` (matmuls and convolutions,
forward and backward, as PyTorch's counter formulas give them);
``device_peak_flops`` maps the card to its published dense peak. MFU =
(FLOPs / wall time) / peak. The port computes in f32 with TF32 off
(``regress.full_f32``), so its peak is the f32 one, not the tensor
cores'.
"""

from __future__ import annotations

from typing import Optional

import torch

#: dense peak FLOP/s by device-name fragment and dtype, from NVIDIA's H100
#: Tensor Core GPU datasheet: the tensor-core rates are the sheet's
#: with-sparsity figures halved, f32 is the non-tensor-core rate; the SXM5
#: part reports its name as "NVIDIA H100 80GB HBM3"
_H100_PEAK = {
    "H100 80GB HBM3": {"bf16": 989.5e12, "tf32": 494.5e12, "f32": 67e12},
    "H100 SXM": {"bf16": 989.5e12, "tf32": 494.5e12, "f32": 67e12},
    "H100 PCIe": {"bf16": 756.5e12, "tf32": 378e12, "f32": 51e12},
}
_DTYPE_KEY = {torch.bfloat16: "bf16", torch.float16: "bf16",
              torch.float32: "f32", "tf32": "tf32"}


def device_peak_flops(device=None, dtype=torch.bfloat16) -> Optional[float]:
    """Dense peak FLOP/s of the card for ``dtype`` (torch.bfloat16 or
    float16, torch.float32 outside the tensor cores, or "tf32"), or None
    for the CPU or a card not in the table. ``device`` defaults to the
    current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.current_device()
    if isinstance(device, (str, torch.device)) and \
            torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for fragment, peaks in _H100_PEAK.items():
        if fragment in name:
            return peaks[_DTYPE_KEY[dtype]]
    return None


def program_flops(fn, *args, **kwargs) -> float:
    """The FLOPs of one call fn(*args, **kwargs) as FlopCounterMode counts
    them: 2 per multiply-add of every matmul and convolution (a backward
    pass run inside fn counted too), no elementwise op. The call runs."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def network_fwd_flops(fn, obs: torch.Tensor, *args) -> float:
    """Forward FLOPs per sample of fn(obs, *args) over a batch ``obs``."""
    return program_flops(fn, obs, *args) / obs.shape[0]


def ppo_update_flops(fwd_flops_per_sample: float, nbatch: int,
                     noptepochs: int) -> float:
    """Analytic model FLOPs of one PPO update: the rollout runs every
    sample forward once, each SGD epoch re-runs the whole batch forward
    + backward (bwd = 2x fwd, the standard MFU convention)."""
    return fwd_flops_per_sample * nbatch * (1.0 + 3.0 * noptepochs)
