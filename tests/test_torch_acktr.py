"""The port's K-FAC and ACKTR (toybox_tpu_torch.rl.kfac, rl.acktr) against
the JAX package's.

- ``_factors_dense``, ``_factors_conv``, ``kfac_invert`` and
  ``kfac_apply`` on the same random inputs (a conv of 3 input channels, a
  dense layer): within 1e-5 relative. The conv's A is over (cin, kh, kw)
  patch features and its gradient rows are (kh, kw, cin): the port pairs
  them as JAX does, and pairing them "right" would differ.
- Two ``make_acktr`` updates (Gridworld, conv trunk, hidden 64, 2 envs x
  nsteps 4, invert_every 2: the first inverts, the second reuses the
  inverses) from the JAX params and init taps, fed the JAX rollout
  replayed with JAX's key schedule: the factor EMA and the inverses
  compared on their own (within 1e-5 relative), then the params within
  1e-7 absolute (a trust-region step moves them by about 1e-4 at
  kfac_clip 0.01; measured 7.5e-9) and the metrics.
- The identity learning tests (> 0.7; invert_every 1 and 8) and the conv
  step, tests/test_rl_learning.py:193,203,215.
- ``save_params``: the file JAX's ``load_params`` reads, with the params,
  ``kfac`` and ``perturbations`` collections in the committed files'
  shapes; JAX's file read back; the eval head loads it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_a2c import _closure, _np
from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import acktr as jacktr
from toybox_tpu.rl import kfac as jkfac
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl.distributions import CategoricalPd as JCategoricalPd
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl import a2c, acktr, kfac, ppo
from toybox_tpu_torch.rl.checkpoint import (load_flax_tree, params_from_flax,
                                            state_dict_template)
from toybox_tpu_torch.rl.eval_adapter import load_eval_params
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env

PARAM_ATOL, FACTOR_RTOL = 1e-7, 1e-5


def _close(got, want, what, rtol=FACTOR_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale,
                               err_msg=what)


# ---------------------------------------------------------------------------
# The K-FAC pieces
# ---------------------------------------------------------------------------

def _pieces():
    r = np.random.default_rng(0)
    a_conv = r.normal(size=(2, 9, 9, 3)).astype(np.float32)     # NHWC
    g_conv = r.normal(size=(2, 4, 4, 5)).astype(np.float32)
    a_dense = r.normal(size=(6, 7)).astype(np.float32)
    g_dense = r.normal(size=(6, 4)).astype(np.float32)
    kernel = r.normal(size=(3, 3, 3, 5)).astype(np.float32)     # HWIO
    grads = {"c": {"inner": {"kernel": kernel,
                             "bias": r.normal(size=5).astype(np.float32)}},
             "d": {"inner": {"kernel": r.normal(size=(7, 4)).astype(
                 np.float32), "bias": r.normal(size=4).astype(np.float32)}}}
    return a_conv, g_conv, a_dense, g_dense, grads


META = {"c": ("conv", 3, 2), "d": ("dense",)}


def _port_grads(grads):
    return {"c.inner.weight": torch.tensor(grads["c"]["inner"]["kernel"])
            .permute(3, 2, 0, 1),
            "c.inner.bias": torch.tensor(grads["c"]["inner"]["bias"]),
            "d.inner.weight": torch.tensor(grads["d"]["inner"]["kernel"]).T,
            "d.inner.bias": torch.tensor(grads["d"]["inner"]["bias"])}


def test_kfac_pieces_match_jax():
    a_conv, g_conv, a_dense, g_dense, grads = _pieces()
    j_fac = {"c": jkfac._factors_conv(jnp.asarray(a_conv),
                                      jnp.asarray(g_conv), 3, 2)[:2],
             "d": jkfac._factors_dense(jnp.asarray(a_dense),
                                       jnp.asarray(g_dense))[:2]}
    taps_a = {"c": torch.tensor(a_conv).permute(0, 3, 1, 2),
              "d": torch.tensor(a_dense)}
    taps_g = {"c": torch.tensor(g_conv).permute(0, 3, 1, 2),
              "d": torch.tensor(g_dense)}
    t_fac = kfac.kfac_factors(taps_a, taps_g, META)
    for name in META:
        for i, what in enumerate("AS"):
            _close(t_fac[name][i].numpy(), j_fac[name][i], f"{name} {what}")
    j_inv = jkfac.kfac_invert(j_fac, 0.01)
    t_inv = kfac.kfac_invert(t_fac, 0.01)
    for name in META:
        for i, what in enumerate(("Ainv", "Sinv")):
            _close(t_inv[name][i].numpy(), j_inv[name][i], f"{name} {what}")
    want = jkfac.kfac_apply({"params": jax.tree_util.tree_map(
        jnp.asarray, grads)}, j_inv, META)["params"]
    got = kfac.kfac_apply(_port_grads(grads), t_inv, META)
    _close(got["c.inner.weight"].permute(2, 3, 1, 0).numpy(),
           want["c"]["inner"]["kernel"], "conv kernel")
    _close(got["c.inner.bias"].numpy(), want["c"]["inner"]["bias"],
           "conv bias")
    _close(got["d.inner.weight"].T.numpy(), want["d"]["inner"]["kernel"],
           "dense kernel")
    _close(got["d.inner.bias"].numpy(), want["d"]["inner"]["bias"],
           "dense bias")
    # the pairing is JAX's, not the consistent one: A's (cin, kh, kw)
    # coordinates reordered to the gradient's (kh, kw, cin) rows give
    # another preconditioned kernel
    order = torch.arange(27).reshape(3, 3, 3).permute(1, 2, 0).reshape(-1)
    order = torch.cat([order, torch.tensor([27])])
    Ainv, Sinv = t_inv["c"]
    paired = kfac.kfac_apply(_port_grads(grads), {
        **t_inv, "c": (Ainv[order][:, order], Sinv)}, META)
    assert float((paired["c.inner.weight"] - got["c.inner.weight"])
                 .abs().max()) > 1e-2


def test_kfac_precondition_and_shapes():
    a_conv, g_conv, a_dense, g_dense, grads = _pieces()
    taps_a = {"c": torch.tensor(a_conv).permute(0, 3, 1, 2),
              "d": torch.tensor(a_dense)}
    taps_g = {"c": torch.tensor(g_conv).permute(0, 3, 1, 2),
              "d": torch.tensor(g_dense)}
    got = kfac.kfac_precondition(_port_grads(grads), taps_a, taps_g, META)
    want = kfac.kfac_apply(_port_grads(grads), kfac.kfac_invert(
        kfac.kfac_factors(taps_a, taps_g, META)), META)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    net = acktr.KfacCNNPolicy(4, (84, 84, 4), hidden=64)
    shapes = kfac.kfac_inverse_shapes(net, net.layer_meta())
    jnet = jacktr.KfacCNNPolicy(n_actions=4, hidden=64)
    jv = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 84, 84, 4),
                                                    jnp.uint8))
    jshapes = jkfac.kfac_inverse_shapes(jv, jnet.layer_meta(True))
    assert list(shapes) == list(jshapes)
    for k in shapes:
        assert [tuple(x.shape) for x in shapes[k]] == \
            [tuple(x.shape) for x in jshapes[k]], k


# ---------------------------------------------------------------------------
# make_acktr against JAX: two updates
# ---------------------------------------------------------------------------

NENVS, NSTEPS, HIDDEN, INVERT_EVERY, TOTAL = 2, 4, 64, 2, 4


@pytest.fixture(scope="module")
def jax_gridworld():
    env = j_make_rl_env("gridworld", NENVS)
    init_fn, train_step, _ = jacktr.make_acktr(
        env, nsteps=NSTEPS, hidden=HIDDEN, invert_every=INVERT_EVERY,
        total_updates=TOTAL, kfac_clip=0.01)
    apply = _closure(train_step, "_apply")

    @jax.jit
    def replay(state):
        def body(carry, _):
            env_state, key = carry
            obs = env_state.frames
            key, akey = jax.random.split(key)
            logits, _ = apply(state.params, obs)
            actions = JCategoricalPd(logits).sample(akey)
            env_state, _, rewards, dones, _ = env.step(
                env_state, actions.astype(jnp.int32))
            return (env_state, key), (obs, actions, rewards, dones)

        (env_state, _), (obs, actions, rewards, dones) = jax.lax.scan(
            body, (state.env_state, state.key), None, length=NSTEPS)
        return dict(obs=obs, actions=actions, rewards=rewards, dones=dones,
                    last_value=apply(state.params, env_state.frames)[1])

    step = jax.jit(train_step)
    states, inputs, metrics = [init_fn(0)], [], []
    for _ in range(2):
        inputs.append(_np(replay(states[-1])))
        s, m = step(states[-1])
        states.append(s)
        metrics.append(_np(m))
    return dict(env=env, states=states, inputs=inputs, metrics=metrics)


def _fc0_order(net) -> torch.Tensor:
    """Indices taking fc0's JAX input coordinates ((h, w, c), then the 1)
    to the port's ((c, h, w), then the 1)."""
    c, h, w = net.conv_out
    order = torch.arange(c * h * w).reshape(h, w, c).permute(2, 0, 1)
    return torch.cat([order.reshape(-1), torch.tensor([c * h * w])])


def test_two_updates_match_jax_train_step(jax_gridworld):
    tenv = t_make_rl_env("gridworld", NENVS, device="cpu")
    init_fn, _, net = acktr.make_acktr(
        tenv, nsteps=NSTEPS, hidden=HIDDEN, invert_every=INVERT_EVERY,
        total_updates=TOTAL, kfac_clip=0.01, device="cpu")
    state = init_fn(0)
    states = jax_gridworld["states"]
    variables = _np(states[0].params)
    net.load_state_dict(params_from_flax(variables))
    for name, d in variables["kfac"].items():
        state.kfac_a[name] = acktr._tap_from_flax(net, name, d["a"][0],
                                                  "cpu")
    hp = acktr.Hyper(kfac_clip=0.01, invert_every=INVERT_EVERY)
    order = _fc0_order(net)
    for u, x in enumerate(jax_gridworld["inputs"]):
        t = {k: torch.tensor(v) for k, v in x.items()}
        returns = a2c.discounted_returns(t["rewards"], t["dones"],
                                         t["last_value"], 0.99)
        lrnow, _ = ppo.anneal(u, TOTAL, 0.25, 0.0, floor=0.05)
        m = acktr.kfac_step(state, t["obs"].reshape((-1, 84, 84, 4)),
                            t["actions"].reshape(-1).long(),
                            returns.reshape(-1), lrnow, hp,
                            tenv.num_actions)
        state.update += 1
        want = states[u + 1]
        for what, got_tree, want_tree in (
                ("stats", state.kfac_stats, want.kfac_stats),
                ("inverse", state.kfac_inv, want.kfac_inv)):
            for name, (A, S) in got_tree.items():
                if name == "fc0":
                    A = A[order][:, order]
                _close(A.numpy(), want_tree[name][0], f"{u} {what} {name} A")
                _close(S.numpy(), want_tree[name][1], f"{u} {what} {name} S")
        got = net.state_dict()
        want_sd = params_from_flax(_np(want.params))
        before = params_from_flax(_np(states[u].params))
        moved = max(float((want_sd[k] - before[k]).abs().max())
                    for k in want_sd)
        worst = max(float((got[k] - want_sd[k]).abs().max())
                    for k in want_sd)
        print(f"update {u}: moved {moved:.3g}, port vs JAX {worst:.3g}")
        assert moved > 100 * PARAM_ATOL, moved
        for k in want_sd:
            np.testing.assert_allclose(got[k].numpy(), want_sd[k].numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=k)
        for k in acktr.METRICS:
            np.testing.assert_allclose(
                float(m[k]), float(jax_gridworld["metrics"][u][k]),
                rtol=1e-5, atol=1e-7, err_msg=f"{u} {k}")


def test_save_params_round_trips_through_jax(jax_gridworld, tmp_path):
    tenv = t_make_rl_env("gridworld", NENVS, device="cpu")
    init_fn, _, net = acktr.make_acktr(tenv, hidden=HIDDEN, device="cpu")
    state = init_fn(5)
    path = str(tmp_path / "port.model")
    acktr.save_params(path, state)
    template = jax_gridworld["states"][0].params
    loaded = _np(jppo.load_params(path, template))
    assert jax.tree_util.tree_structure(loaded) == \
        jax.tree_util.tree_structure(_np(template))
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(_np(template))):
        assert a.shape == b.shape
    for name, d in loaded["kfac"].items():      # the init's zero-obs inputs
        np.testing.assert_array_equal(d["a"][0],
                                      _np(template)["kfac"][name]["a"][0])
    back = params_from_flax(loaded)
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k
    # JAX's file into the port's state, and through the eval head
    jpath = str(tmp_path / "jax.model")
    jppo.save_params(jpath, jax_gridworld["states"][2].params)
    acktr.load_params(jpath, state)
    want = params_from_flax(_np(jax_gridworld["states"][2].params))
    for k, v in net.state_dict().items():
        assert torch.equal(v, want[k]), k
    # at the recipe's width: the committed file's collections and shapes,
    # and the eval head loads the file
    tree = load_flax_tree("models/Breakout.acktr.model")
    bk = acktr.make_acktr(t_make_rl_env("breakout", 1, device="cpu"),
                          device="cpu")[0](0)
    bpath = str(tmp_path / "bk.model")
    acktr.save_params(bpath, bk)
    mine = load_flax_tree(bpath)
    assert set(mine) == set(tree) == {"params", "kfac", "perturbations"}
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert jax.tree_util.tree_map(np.shape, mine) == shapes
    head = load_eval_params("acktr", "cnn", bpath, "breakout", device="cpu")
    for k, v in head.state_dict().items():
        assert torch.equal(v, bk.module.state_dict()[k]), k


# ---------------------------------------------------------------------------
# Learning, the conv step, the flat-vector policy's template
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("invert_every", [1, 8])
def test_acktr_learns_identity(invert_every):
    """tests/test_rl_learning.py:193-212 in the port."""
    env = make_discrete_identity_env(16, dim=4, device="cpu")
    init_fn, step, _ = acktr.make_acktr(
        env, nsteps=8, lr=0.2, gamma=0.1, hidden=32, kfac_clip=0.01,
        total_updates=3000, invert_every=invert_every, device="cpu")
    state = init_fn(0)
    for _ in range(200):
        state, metrics = step(state)
    r = float(metrics["mean_reward"])
    assert r > 0.7, f"acktr (invert_every={invert_every}) failed: {r}"
    assert state_dict_template(state.module.state_dict()) == "kfac:mlp"


def test_acktr_conv_step_runs():
    """tests/test_rl_learning.py:215-225 in the port."""
    env = t_make_rl_env("gridworld", 2, device="cpu")
    init_fn, step, _ = acktr.make_acktr(env, nsteps=2, hidden=64,
                                        total_updates=4, device="cpu")
    state, metrics = step(init_fn(0))
    assert np.isfinite(float(metrics["policy_loss"]))
    assert np.isfinite(float(metrics["step_coeff"]))
    assert state.update == 1


def test_flat_policy_round_trips_through_jax(tmp_path):
    from toybox_tpu.rl.test_envs import make_discrete_identity_env as jid
    env = make_discrete_identity_env(4, dim=4, device="cpu")
    init_fn, _, net = acktr.make_acktr(env, hidden=16, device="cpu")
    state = init_fn(1)
    path = str(tmp_path / "flat.model")
    acktr.save_params(path, state)
    jinit, _, jnet = jacktr.make_acktr(jid(4, dim=4), hidden=16)
    template = jinit(0).params
    loaded = _np(jppo.load_params(path, template))
    obs = np.eye(4, dtype=np.float32)
    jl, jv = jnet.apply(loaded, obs)
    with torch.no_grad():
        tl, tv = net(torch.tensor(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
