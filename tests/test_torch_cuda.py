"""The frame kernels on the GPU against their plain PyTorch versions.

Needs an NVIDIA GPU and nvcc; skips elsewhere. Run on the card with
``python -m pytest -m cuda tests/test_torch_cuda.py``."""

import pytest
import torch

from toybox_tpu_torch.core.actions import ale_to_input
from toybox_tpu_torch.games import amidar as am
from toybox_tpu_torch.games import breakout as bk
from toybox_tpu_torch.games import space_invaders as si
from toybox_tpu_torch.ops import obs, render_amidar, render_cuda, render_si

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


def _play(module, cfg, n=64, steps=150):
    """States of ``module`` after random play, and one step more."""
    s = module.new_game(cfg, torch.arange(n, device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(1)
    legal = torch.as_tensor(module.LEGAL_ACTIONS, device="cuda")
    for _ in range(steps):
        a = legal[torch.randint(0, len(legal), (n,), device="cuda",
                                generator=g)]
        s = module.step(cfg, s, ale_to_input(a))
    return s, module.step(cfg, s, ale_to_input(legal[torch.ones(
        n, dtype=torch.long, device="cuda")]))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("game", ["space_invaders", "amidar"])
def test_other_kernels_equal_plain_versions(cuda_config, game, fused):
    if game == "space_invaders":
        cfg = si.default_config("cuda")
        s1, s2 = _play(si, cfg, steps=300)
        preps = [render_si.si_prep(s) for s in (s1, s2)]
        ops, consts, key = render_si, render_si.si_consts(cfg), "si_frame"
    else:
        cfg = am.default_config("cuda")
        s1, s2 = _play(am, cfg)
        painted = s1.box_painted | (torch.rand(
            s1.box_painted.shape, device="cuda") > 0.7)
        s1 = s1.replace(box_painted=painted)
        preps = [render_amidar.amidar_prep(cfg, s) for s in (s1, s2)]
        ops, consts = render_amidar, render_amidar.amidar_consts(cfg)
        key = "amidar_frame"
    prep = torch.stack(preps, 1) if fused else preps[0][:, None]
    key += "_fused" if fused else ""
    before = render_cuda.LAUNCHES[key]
    got = ops.render_frames(prep, consts)
    torch.cuda.synchronize()
    assert render_cuda.LAUNCHES[key] == before + 1
    assert torch.equal(got, ops.frame_plain(prep, consts))


@pytest.mark.parametrize("game", ["breakout", "space_invaders", "amidar"])
def test_warp_kernels_equal_plain_versions(cuda_config, game):
    """Each fused frame kernel's warp form (``<kernel>_fused_warp``) is
    exactly its plain version: both sum each band in the same order."""
    if game == "breakout":
        s1 = _states(cuda_config)
        s2 = bk.step(cuda_config, s1, ale_to_input(torch.ones(
            64, dtype=torch.long, device="cuda")))
        preps = [render_cuda.breakout_prep(s) for s in (s1, s2)]
        ops, consts = render_cuda, render_cuda.breakout_lumas(cuda_config)
        key, hw = "breakout_frame", (bk.HEIGHT, bk.WIDTH)
    elif game == "space_invaders":
        cfg = si.default_config("cuda")
        s1, s2 = _play(si, cfg, steps=300)
        preps = [render_si.si_prep(s) for s in (s1, s2)]
        ops, consts, key = render_si, render_si.si_consts(cfg), "si_frame"
        hw = (si.HEIGHT, si.WIDTH)
    else:
        cfg = am.default_config("cuda")
        s1, s2 = _play(am, cfg)
        preps = [render_amidar.amidar_prep(cfg, s) for s in (s1, s2)]
        ops, consts = render_amidar, render_amidar.amidar_consts(cfg)
        key, hw = "amidar_frame", (am.HEIGHT, am.WIDTH)
    tables = obs.warp_tables(*hw, 84, "cuda")
    prep = torch.stack(preps, 1)
    key += "_fused_warp"
    before = render_cuda.LAUNCHES[key]
    got = ops.render_frames(prep, consts, tables)
    torch.cuda.synchronize()
    assert render_cuda.LAUNCHES[key] == before + 1
    assert tuple(got.shape) == (64, 84, 84)
    assert torch.equal(got, ops.frame_warp_plain(prep, consts, tables))
