"""The Breakout frame kernel on the GPU against its plain PyTorch version.

Needs an NVIDIA GPU and nvcc; skips elsewhere. Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import pytest
import torch

from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.ops import render_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_config():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return bk.default_config("cuda")


def _states(cfg, n=64, steps=40):
    s = bk.new_game(cfg, torch.arange(n, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(0)
    for i in range(steps):
        a = torch.randint(0, 4, (n,), device="cuda", generator=g)
        a = torch.as_tensor(bk.LEGAL_ACTIONS, device="cuda")[a]
        if i % 8 == 0:
            a = torch.ones_like(a)
        s = bk.step(cfg, s, ale_to_input(a))
    keep = torch.rand(s.brick_alive.shape, device="cuda", generator=g) > 0.3
    return s.replace(brick_alive=s.brick_alive & keep)


@pytest.mark.parametrize("fused", [False, True])
def test_kernel_equals_plain_version(cuda_config, fused):
    cfg = cuda_config
    s1 = _states(cfg)
    s2 = bk.step(cfg, s1, ale_to_input(torch.ones(64, dtype=torch.long,
                                                  device="cuda")))
    p = [render_cuda.breakout_prep(s) for s in (s1, s2)]
    prep = torch.stack(p, 1) if fused else p[0][:, None]
    lumas = render_cuda.breakout_lumas(cfg)
    key = "breakout_frame_fused" if fused else "breakout_frame"
    before = render_cuda.LAUNCHES[key]
    got = render_cuda.render_frames(prep, lumas)
    torch.cuda.synchronize()
    assert render_cuda.LAUNCHES[key] == before + 1
    assert torch.equal(got, render_cuda.frame_plain(prep, lumas))


def test_wrapper_rejects_non_contiguous(cuda_config):
    prep = torch.zeros(4, render_cuda.PREP, 2, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError):
        render_cuda.render_frames(prep, (0.0, 0.0, 0.0, 0.0))
