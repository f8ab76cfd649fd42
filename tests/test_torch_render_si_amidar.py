"""The port's Space Invaders and Amidar frames (each CUDA kernel's plain
version, which CPU tensors take) against the JAX package: exactly equal to
``luma2d(<game>.render)`` and to the Pallas kernels in interpret mode
(tests/test_render_pallas.py allows the Pallas kernels 1 grey level; at
the default colors they are exact too), single and fused, at the states
tests/test_render_pallas.py uses plus doctored ones."""

import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
import toybox_tpu.games.amidar as jam
import toybox_tpu.games.space_invaders as jsi
from toybox_tpu.core.actions import ale_to_input
from toybox_tpu.games.common import luma2d as j_luma2d
from toybox_tpu.ops import render_pallas as rp
from toybox_tpu_torch.games import amidar as tam
from toybox_tpu_torch.games import space_invaders as tsi
from toybox_tpu_torch.games.common import luma2d as t_luma2d
from toybox_tpu_torch.ops import obs as tobs
from toybox_tpu_torch.ops import render_amidar, render_cuda, render_si

N = 4


def to_torch(tmod, js):
    """A batched JAX state -> the port's State (u32 words as int64)."""
    out = {}
    for f in tmod.FIELDS:
        a = np.asarray(getattr(js, f))
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[f] = torch.tensor(a)
    return tmod.State(**out)


def _rollout(jmod, steps, action, seed0=0):
    """The rollout of tests/test_render_pallas.py, and one step more."""
    cfg = jmod.default_config()
    s = jax.vmap(lambda x: jmod.new_game(cfg, seed=x))(
        jnp.arange(seed0, seed0 + N, dtype=jnp.uint32))
    step = jax.jit(jax.vmap(jmod.step, in_axes=(None, 0, 0)))
    acts = ale_to_input(jnp.full(N, action, jnp.int32))
    for _ in range(steps):
        s = step(cfg, s, acts)
    return cfg, step, acts, s


def _si_states(steps):
    cfg, step, acts, s = _rollout(jsi, steps, 11)
    # env 1: the UFO flies over the formation's right edge, an enemy dies
    # (its death animation still draws); env 2: the ship is down and a
    # laser sits on a shield; env 3: a shield half eroded
    def put(field, env, value):
        a = np.asarray(getattr(s, field)).copy()
        a[env] = value
        return a
    s = s.replace(
        ufo_appearance_counter=jnp.asarray(put("ufo_appearance_counter", 1,
                                               0)),
        ufo_x=jnp.asarray(put("ufo_x", 1, 100)),
        enemy_alive=jnp.asarray(put("enemy_alive", 1, np.arange(36) % 5 > 0)),
        enemy_death_counter=jnp.asarray(
            put("enemy_death_counter", 1, np.where(np.arange(36) == 5, 7,
                                                   -1))),
        ship_alive=jnp.asarray(put("ship_alive", 2, False)),
        ship_death_counter=jnp.asarray(put("ship_death_counter", 2, -1)),
        ship_laser_alive=jnp.asarray(put("ship_laser_alive", 2, True)),
        ship_laser_x=jnp.asarray(put("ship_laser_x", 2, 150)),
        ship_laser_y=jnp.asarray(put("ship_laser_y", 2, 160)),
    )
    alpha = np.asarray(s.shield_alpha).copy()
    alpha[3, 1, :9] = False
    s = s.replace(shield_alpha=jnp.asarray(alpha))
    return cfg, s, step(cfg, s, acts)


def _amidar_states(steps):
    cfg, step, acts, s = _rollout(jam, steps, 4)
    # painted boxes (their interiors draw), an enemy on the player in env 2
    painted = np.asarray(s.box_painted).copy()
    painted[0, [0, 3, 7]] = True
    painted[1, 10:20] = True
    ex = np.asarray(s.enemy_x).copy()
    ey = np.asarray(s.enemy_y).copy()
    ex[2, 1] = int(s.player_x[2]) + 16
    ey[2, 1] = int(s.player_y[2]) + 16
    s = s.replace(box_painted=jnp.asarray(painted), enemy_x=jnp.asarray(ex),
                  enemy_y=jnp.asarray(ey))
    return cfg, s, step(cfg, s, acts)


GAMES = {
    "space_invaders": (jsi, tsi, _si_states, 300,
                       rp.make_si_gray_renderer,
                       rp.make_si_gray_maxpool_renderer,
                       render_si.make_si_gray_renderer,
                       render_si.make_si_gray_maxpool_renderer),
    "amidar": (jam, tam, _amidar_states, 180,
               rp.make_amidar_gray_renderer,
               rp.make_amidar_gray_maxpool_renderer,
               render_amidar.make_amidar_gray_renderer,
               render_amidar.make_amidar_gray_maxpool_renderer),
}


def _jax_frames(jmod, cfg, s):
    return np.asarray(jax.vmap(lambda x: j_luma2d(jmod.render(cfg, x)))(s))


@pytest.mark.parametrize("game", sorted(GAMES))
def test_single_frame_matches_jax_render_and_pallas(game):
    jmod, tmod, states, steps, pl1, _, port1, _ = GAMES[game]
    cfg, s, _ = states(steps)
    tcfg = tmod.default_config("cpu")
    ts = to_torch(tmod, s)
    port = port1(tcfg)(ts).numpy()
    assert port.shape == (N, tmod.HEIGHT, tmod.WIDTH)
    assert port.dtype == np.uint8
    np.testing.assert_array_equal(port, _jax_frames(jmod, cfg, s))
    np.testing.assert_array_equal(port, pl1(cfg, interpret=True)(s))
    # the port's own RGBA render agrees with its frame kernel's plain form
    np.testing.assert_array_equal(port,
                                  t_luma2d(tmod.render(tcfg, ts)).numpy())


@pytest.mark.parametrize("game", sorted(GAMES))
def test_fused_frame_matches_max_of_jax_renders_and_pallas(game):
    jmod, tmod, states, steps, _, pl2, _, port2 = GAMES[game]
    cfg, s1, s2 = states(steps)
    tcfg = tmod.default_config("cpu")
    port = port2(tcfg)(to_torch(tmod, s1), to_torch(tmod, s2)).numpy()
    want = np.maximum(_jax_frames(jmod, cfg, s1), _jax_frames(jmod, cfg, s2))
    np.testing.assert_array_equal(port, want)
    np.testing.assert_array_equal(port, pl2(cfg, interpret=True)(s1, s2))


def test_si_consts_refuse_what_the_kernel_cannot_draw():
    cfg = tsi.default_config("cpu")
    for shields in ([[84, 157], [148, 157], [212, 157], [20, 157]],
                    [[84, 157], [148, 150]], [[310, 157]]):
        bad = tsi.config_from_json(dict(tsi._DEFAULT_CONFIG_JSON,
                                        shields=shields), "cpu")
        with pytest.raises(ValueError):
            render_si.si_consts(bad)
    # fewer shields are drawn, the rest padded
    two = tsi.config_from_json(dict(tsi._DEFAULT_CONFIG_JSON,
                                    shields=[[84, 157], [212, 157]]), "cpu")
    s = tsi.new_game(two, torch.arange(2))
    got = render_si.make_si_gray_renderer(two)(s)
    np.testing.assert_array_equal(got.numpy(),
                                  t_luma2d(tsi.render(two, s)).numpy())
    assert render_si.si_consts(cfg)[6:] == (3.0, 157.0, 84.0, 148.0, 212.0)


@pytest.mark.parametrize("h,w", [(210, 320), (250, 160)])
def test_warp_matrices_match_jax(h, w):
    """The triangle filter widens for both downsampling shapes."""
    np.testing.assert_array_equal(tobs.bilinear_matrix(84, h),
                                  rp._bilinear_matrix(84, h))
    np.testing.assert_array_equal(tobs.bilinear_matrix(84, w),
                                  rp._bilinear_matrix(84, w))


@pytest.mark.parametrize("wrapper,prep_len", [
    (render_si.render_frames, render_si.PREP),
    (render_amidar.render_frames, render_amidar.PREP)])
def test_wrappers_check_inputs(wrapper, prep_len):
    consts = (0.0,) * 11 if prep_len == render_si.PREP else (0.0,) * 6
    with pytest.raises(ValueError):
        wrapper(torch.zeros(2, 3, prep_len), consts)
    with pytest.raises(ValueError):
        wrapper(torch.zeros(2, 1, prep_len + 1), consts)
    with pytest.raises(TypeError):
        wrapper(torch.zeros(2, 1, prep_len, dtype=torch.float64), consts)
    before = dict(render_cuda.LAUNCHES)
    wrapper(torch.zeros(2, 2, prep_len), consts)
    assert render_cuda.LAUNCHES == before      # the plain version, no launch


# A stand-in for nvcc: it marks its source as started, waits until every
# expected build has started (so it succeeds only if the builds run at the
# same time), refuses a source that holds BROKEN, and writes the "library".
_FAKE_NVCC = textwrap.dedent("""\
    import os, pathlib, sys, time
    args = sys.argv[1:]
    out, src = pathlib.Path(args[args.index("-o") + 1]), pathlib.Path(args[-1])
    marks = pathlib.Path(os.environ["FAKE_NVCC_MARKS"])
    (marks / (src.stem + ".started")).touch()
    deadline = time.time() + 60
    while len(list(marks.glob("*.started"))) < int(os.environ["FAKE_NVCC_N"]):
        if time.time() > deadline:
            sys.exit("builds did not run together")
        time.sleep(0.01)
    if "BROKEN" in src.read_text():
        sys.exit("error: " + src.name)
    out.write_bytes(b"built " + src.name.encode())
    print("ptxas info    : Used 10 registers, " + src.stem)
""")


def _fake_nvcc(tmp_path, monkeypatch, n):
    script = tmp_path / "nvcc.py"
    script.write_text(_FAKE_NVCC)
    marks = tmp_path / "marks"
    marks.mkdir()
    monkeypatch.setenv("FAKE_NVCC_MARKS", str(marks))
    monkeypatch.setenv("FAKE_NVCC_N", str(n))
    monkeypatch.setattr(render_cuda, "_nvcc",
                        lambda: [sys.executable, str(script)])
    monkeypatch.setattr(render_cuda, "BUILD_DIR", tmp_path / "kernels")
    return marks


def test_build_compiles_every_source_at_once_and_caches(tmp_path,
                                                        monkeypatch):
    names = {p.stem for p in render_cuda.CSRC.glob("*.cu")}
    assert names == {"breakout_frame", "si_frame", "amidar_frame"}
    marks = _fake_nvcc(tmp_path, monkeypatch, len(names))
    built = render_cuda.build()
    assert set(built) == names
    for name, (path, log) in built.items():
        assert path.read_bytes() == f"built {name}.cu".encode()
        assert path.name.startswith(name + "-") and f"registers, {name}" in log
    assert len(list(marks.glob("*.started"))) == len(names)
    # built once: the next call compiles nothing
    for m in marks.iterdir():
        m.unlink()
    again = render_cuda.build()
    assert {k: (p, log) for k, (p, log) in again.items()} == {
        k: (p, "") for k, (p, _) in built.items()}
    assert not list(marks.iterdir())
    assert sorted(p.name for p in (tmp_path / "kernels").iterdir()) == \
        sorted(p.name for p, _ in built.values())


def test_build_reports_a_failed_source(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "good.cu").write_text("// fine\n")
    (csrc / "bad.cu").write_text("// BROKEN\n")
    monkeypatch.setattr(render_cuda, "CSRC", csrc)
    _fake_nvcc(tmp_path, monkeypatch, 2)
    with pytest.raises(RuntimeError, match="bad.cu"):
        render_cuda.build()
    # the good library is kept, no temporary file is left behind
    assert [p.name.split("-")[0] for p in
            (tmp_path / "kernels").iterdir()] == ["good"]
