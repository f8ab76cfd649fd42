"""The port's TRPO (toybox_tpu_torch.rl.trpo) against the JAX package's.

- ``CategoricalPd.kl`` against JAX's.
- ``trust_region_update`` on a fed batch (cnn_small, 32 random frames,
  random actions and advantages, the old neglogps the policy's own)
  against JAX's and against the port's own step in float64: the params,
  ``accepted``, ``kl`` and the surrogate gain, at max_kl 0.001 (the
  first step accepted) and 50 (the search backtracks to its third
  step). The line search compares gains and KL against thresholds, so
  the test first checks, on the port's record of the search, that no
  comparison up to the accepted step is a near tie (margins above 1e-3
  of their scale), then compares ``accepted`` exactly.
- One update (JAX's ``update_step``, the port's ``optimize``) fed JAX's
  rollout (``rollout_step``'s batch; Gridworld, 2 envs x nsteps 16,
  cnn_small): policy, value network and its Adam moments, and metrics.
- Tolerance. The step is stepdir / sqrt(shs / max_kl) after ten
  conjugate-gradient iterations on Fisher-vector products, which carry
  float-order differences from one iteration to the next (the flat
  vector is also raveled in the module's order, where JAX ravels flax's
  sorted keys). Measured on the fed batch, against the same step in
  float64: the port's f32 step is off by 7.8e-7 of its largest move,
  JAX's by 1.5e-4 at both max_kl. So the port is held to the float64
  step at 1e-5 of the largest move, and to JAX's step, kl and gain at
  1e-3 (relative); the value network's Adam steps at 1e-6 absolute, as
  PPO's.
- (The identity learning test: tests/test_torch_replay_learning.py.)
- ``learn`` and ``run.main --alg=trpo|trpo_mpi``: the saved file in JAX's
  ``load_params`` and the port's ``load_eval_params``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from tests.test_torch_dqn import (_assert_close, _assert_named, _np, _t)
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import ppo as jppo
from toybox_tpu.rl import trpo as jtrpo
from toybox_tpu.rl.distributions import CategoricalPd as JCategoricalPd
from toybox_tpu.rl.policies import build_policy as j_build_policy
from toybox_tpu_torch import run
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl import trpo
from toybox_tpu_torch.rl.checkpoint import params_from_flax
from toybox_tpu_torch.rl.distributions import CategoricalPd
from toybox_tpu_torch.rl.eval_adapter import load_eval_params
from toybox_tpu_torch.rl.policies import build_policy
from toybox_tpu_torch.rl.test_envs import make_discrete_identity_env

TR_RTOL, F64_RTOL = 1e-3, 1e-5
OBS = (84, 84, 4)


def test_categorical_kl_matches_jax():
    r = np.random.default_rng(0)
    a = (3 * r.normal(size=(5, 7, 6))).astype(np.float32)
    b = (3 * r.normal(size=(5, 7, 6))).astype(np.float32)
    want = JCategoricalPd(jnp.asarray(a)).kl(JCategoricalPd(jnp.asarray(b)))
    got = CategoricalPd(_t(a)).kl(CategoricalPd(_t(b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert float(CategoricalPd(_t(a)).kl(CategoricalPd(_t(a))).abs().max()) \
        < 1e-6


def _check_no_near_tie(search, accepted: bool, max_kl: float) -> int:
    """The first accepted line-search step (or -1): every comparison up to
    it is at least 1e-3 of its scale away from its threshold."""
    gains = search["gains"].numpy() - float(search["gain0"])
    need = 0.1 * 0.5 ** np.arange(len(gains)) * float(
        search["expected_improve"])
    kl_margin = 1.5 * max_kl - search["kls"].numpy()
    ok = (gains > need) & (kl_margin >= 0)
    first = int(np.argmax(ok)) if ok.any() else -1
    assert bool(ok.any()) == accepted
    last = first if first >= 0 else len(gains) - 1
    for i in range(last + 1):
        assert abs(gains[i] - need[i]) > 1e-3 * abs(need[0]), i
        assert abs(kl_margin[i]) > 1e-3 * max_kl, i
    return first


def _f64(module):
    """A float64 copy of a cnn_small PolicyWithValue (its trunk's convs,
    Dense and heads all in float64)."""
    m = copy.deepcopy(module).double()

    def trunk(x):
        x = x.permute(0, 3, 1, 2).double() / 255.0
        for i in range(m.trunk.n_convs):
            x = torch.relu(getattr(m.trunk, f"conv{i}")(x))
        return torch.relu(m.trunk.fc(x.flatten(1)))

    m.trunk.forward = trunk
    return m


def _assert_step(got: dict, want: dict, before: dict, rtol: float, what):
    """got within rtol of the largest move of want from before."""
    move = max(float((want[k] - before[k]).abs().max()) for k in want)
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert move > 1e-3, f"{what}: the step moved the params by {move}"
    assert worst <= rtol * move, f"{what}: {worst} of a {move} step"
    return worst / move


@pytest.mark.parametrize("max_kl", [0.001, 50.0])
def test_trust_region_update_matches_jax(max_kl):
    r = np.random.default_rng(1)
    n, nact = 32, 4
    obs = r.integers(0, 256, (n,) + OBS).astype(np.uint8)
    acts = r.integers(0, nact, n).astype(np.int32)
    adv = r.normal(size=n).astype(np.float32)
    jmod, jinit, jstep, _ = j_build_policy(OBS, nact, "cnn_small")
    params = jinit(jax.random.PRNGKey(2))
    logits, _ = jmod.apply(params, jnp.asarray(obs))
    nlp = np.asarray(JCategoricalPd(logits).neglogp(jnp.asarray(acts)))
    new, jm = jax.jit(lambda p: jtrpo.trust_region_update(
        jmod, nact, p, jnp.asarray(obs), jnp.asarray(acts),
        jnp.asarray(adv), jnp.asarray(nlp), max_kl=max_kl))(params)
    module = build_policy(OBS, nact, "cnn_small", device="cpu")[0]
    before = params_from_flax(_np(params))
    module.load_state_dict(before)
    ref = _f64(module)
    batch = (_t(obs), _t(acts).long(), _t(adv), _t(nlp))
    m, search = trpo.trust_region_update(module, nact, *batch,
                                         max_kl=max_kl)
    first = _check_no_near_tie(search, bool(jm["accepted"]), max_kl)
    assert (first == 0) == (max_kl < 0.01), first   # 50: it backtracks
    assert float(m["accepted"]) == float(jm["accepted"]) == 1.0
    got = module.state_dict()
    trpo.trust_region_update(ref, nact, batch[0], batch[1],
                             batch[2].double(), batch[3].double(),
                             max_kl=max_kl)
    exact = {k: v.float() for k, v in ref.state_dict().items()}
    _assert_step(got, exact, before, F64_RTOL, "port vs float64")
    _assert_step(got, params_from_flax(_np(new)), before, TR_RTOL,
                 "port vs JAX")
    for k in ("kl", "surrogate_gain"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TR_RTOL,
                                   err_msg=k)


def test_one_update_matches_jax_fed_its_rollout():
    env = j_make_rl_env("gridworld", 2)
    init_fn, _, rollout_step, update_step = jtrpo.make_trpo(
        env, network="cnn_small", nsteps=16)
    s0 = jax.jit(init_fn, static_argnums=0)(0)
    _, batch, _ = jax.jit(rollout_step)(s0)
    s1, jm = jax.jit(update_step)(s0, batch)
    b = _np(batch)
    # the port's Gridworld env only resets: the update is fed JAX's batch
    tinit, step = trpo.make_trpo(t_make_rl_env("gridworld", 2, device="cpu"),
                                 network="cnn_small", nsteps=16,
                                 device="cpu")
    st = tinit(0)
    st.module.load_state_dict(params_from_flax(_np(s0.pi_params)))
    st.vf.load_state_dict(params_from_flax(_np(s0.vf_params)))
    fb = (_t(b["fobs"]), _t(b["facts"]).long(), _t(b["fadv"]),
          _t(b["fnlp_old"]), _t(b["fret"]))
    st, m = step.optimize(st, (fb, {}))
    assert float(jm["accepted"]) == float(m["accepted"]) == 1.0
    _assert_step(st.module.state_dict(), params_from_flax(_np(s1.pi_params)),
                 params_from_flax(_np(s0.pi_params)), TR_RTOL, "pi")
    _assert_named(st.vf.state_dict(), s1.vf_params, "vf")
    adam = next(s for s in jax.tree_util.tree_leaves(
        s1.vf_opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState)) if isinstance(
                s, optax.ScaleByAdamState))
    assert st.vf_adam.count == int(adam.count) == 3
    names = [n for n, _ in st.vf.named_parameters()]
    _assert_named(dict(zip(names, st.vf_adam.mu)), adam.mu, "mu")
    _assert_named(dict(zip(names, st.vf_adam.nu)), adam.nu, "nu")
    assert set(m) == set(jm)
    for k in ("vf_loss", "entropy"):
        _assert_close(m[k], jm[k], k)
    for k in ("kl", "surrogate_gain"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TR_RTOL,
                                   err_msg=k)


def test_learn_logs_and_saves_for_jax(tmp_path):
    class Rows:
        def __init__(self):
            self.rows, self.row = [], {}

        def logkv(self, k, v):
            self.row[k] = v

        def dumpkvs(self):
            self.rows.append(self.row)
            self.row = {}

    log, path = Rows(), str(tmp_path / "t.model")
    state = trpo.learn(env=make_discrete_identity_env(4, dim=3,
                                                      device="cpu"),
                       network="mlp", nsteps=8, total_timesteps=3 * 32,
                       logger=log, network_kwargs=dict(num_hidden=8),
                       device="cpu", save_path=path)
    assert state.update == 3 and [r["nupdates"] for r in log.rows] == [1, 2,
                                                                       3]
    assert set(log.rows[0]) == {"nupdates", "fps", "eprewmean",
                                "mean_reward", *trpo.METRICS}
    jinit = j_build_policy((3,), 3, "mlp", num_hidden=8)[1]
    template = jinit(jax.random.PRNGKey(0))
    back = params_from_flax(_np(jppo.load_params(path, template)))
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("alg", ["trpo", "trpo_mpi"])
def test_run_main_trains_and_saves_trpo(alg, tmp_path):
    path = str(tmp_path / "trpo.model")
    state = run.main([f"--alg={alg}", "--env=BreakoutToyboxNoFrameskip-v4",
                      "--num_envs=2", "--nsteps=4", "--num_timesteps=64",
                      "--device=cpu", f"--save_path={path}",
                      f"--log_path={tmp_path / 'log'}"])
    assert state.update == 2
    template = j_build_policy(OBS, 4, "cnn_small")[1](jax.random.PRNGKey(0))
    back = params_from_flax(_np(jppo.load_params(path, template)))
    head = load_eval_params("trpo", "cnn_small", path, "breakout",
                            device="cpu")
    for k, v in state.module.state_dict().items():
        assert torch.equal(back[k], v), k
        assert torch.equal(head.state_dict()[k], v), k
    with pytest.raises(TypeError, match="unexpected"):
        trpo.learn(env=make_discrete_identity_env(2, dim=3, device="cpu"),
                   cycles_per_jit=2, device="cpu")
