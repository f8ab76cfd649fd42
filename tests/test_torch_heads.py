"""The port's eval heads against the JAX package's, one committed
checkpoint per family (the six param-tree templates among them), each
loaded by the package's own ``load_eval_params``, on the same N = 4 uint8
observation stacks (numpy, seed 0): logits and value, acer's Q and
E_pi[Q], deepq's dueling Q and greedy action, acktr's K-FAC policy, and
the recurrent heads stepped T = 6 with one env done at t = 3 (outputs and
carry at every step). Tolerance: 1e-5 of each output's largest magnitude
(at least 1e-5 absolute), the f32 sums of the two packages running in
other orders; the bf16 trunk within 4 bf16 steps of its largest output."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toybox_tpu.rl import eval_adapter as j_adapter
from toybox_tpu.rl.acer import RecurrentQPolicy as JRecurrentQPolicy
from toybox_tpu.rl.acktr import KfacCNNPolicy as JKfacCNNPolicy
from toybox_tpu.rl.dqn import QNetwork as JQNetwork
from toybox_tpu.rl.models import get_network_builder
from toybox_tpu.rl.policies import PolicyWithValue as JPolicyWithValue
from toybox_tpu.rl.policies import build_eval_policy as j_build_eval_policy
from toybox_tpu.rl.ppo_recurrent import \
    RecurrentPolicyWithValue as JRecurrentPolicyWithValue
from toybox_tpu_torch.rl.eval_adapter import load_eval_params
from toybox_tpu_torch.rl.models import NatureCNN
from toybox_tpu_torch.rl.policies import build_eval_policy, expected_q

N, T, DONE_AT = 4, 6, 3
N_ACT = {"breakout": 4, "space_invaders": 6, "amidar": 10}
#: (checkpoint, alg, network, game): every feed-forward family
FEEDFORWARD = [
    ("Breakout.ppo1", "ppo1", "cnn", "breakout"),
    ("SpaceInvaders.a2c", "a2c", "cnn", "space_invaders"),
    ("Amidar.gail", "gail", "cnn", "amidar"),
    ("Breakout.bc", "gail", "cnn", "breakout"),
    ("Amidar.trpo", "trpo", "cnn_small", "amidar"),
    ("SpaceInvaders.acer", "acer", "cnn_small", "space_invaders"),
    ("Breakout.deepq", "deepq", "conv_only", "breakout"),
    ("Amidar.acktr", "acktr", "cnn", "amidar"),
]
RECURRENT = [
    ("Amidar.ppo_lstm", "ppo", "cnn_lstm", "amidar"),
    ("Breakout.ppo_lnlstm", "ppo", "cnn_lnlstm", "breakout"),
    ("SpaceInvaders.acer_lstm", "acer", "cnn_lstm", "space_invaders"),
]


def _obs(seed=0, n=N):
    return np.random.default_rng(seed).integers(0, 256, (n, 84, 84, 4),
                                                dtype=np.uint8)


def assert_close(got, want, what, scale=1e-5):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = scale * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max diff {err} > {tol}"


@functools.lru_cache(maxsize=None)
def _jax_params(name, alg, network, game):
    return j_adapter.load_eval_params(alg, network, f"models/{name}.model",
                                      game)


def _jax_module(alg, network, n_act):
    if alg == "deepq":
        return JQNetwork(trunk=get_network_builder(network)(),
                         n_actions=n_act)
    if alg == "acktr":
        return JKfacCNNPolicy(n_actions=n_act)
    if network in ("cnn_lstm", "cnn_lnlstm"):
        cls = (JRecurrentQPolicy if alg == "acer"
               else JRecurrentPolicyWithValue)
        return cls(trunk=get_network_builder(network)(nlstm=128),
                   n_actions=n_act)
    return JPolicyWithValue(trunk=get_network_builder(network)(),
                            n_pdparams=n_act, estimate_q=alg == "acer")


@pytest.mark.parametrize("name,alg,network,game", FEEDFORWARD,
                         ids=[c[0] for c in FEEDFORWARD])
def test_feedforward_head_matches_jax(name, alg, network, game):
    obs = _obs()
    params = _jax_params(name, alg, network, game)
    want = _jax_module(alg, network, N_ACT[game]).apply(params, obs)
    module = load_eval_params(alg, network, f"models/{name}.model", game,
                              device="cpu")
    with torch.no_grad():
        got = module(torch.as_tensor(obs))
    if alg == "deepq":
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, f"{name} output {i}")


def test_deepq_greedy_action_and_value_match_jax():
    name, alg, network, game = FEEDFORWARD[6]
    obs = _obs(1, 16)
    params = _jax_params(name, alg, network, game)
    _, j_step = j_build_eval_policy(alg, (84, 84, 4), N_ACT[game], network)
    j_act, j_val, _, j_q = j_step(params, obs, jax.random.PRNGKey(0),
                                  eps=0.0)
    module, t_step = build_eval_policy(alg, (84, 84, 4), N_ACT[game],
                                       network, device="cpu")
    module.load_state_dict(load_eval_params(
        alg, network, f"models/{name}.model", game,
        device="cpu").state_dict())
    gen = torch.Generator().manual_seed(0)
    act, val, neglogp, q = t_step(torch.as_tensor(obs), gen, eps=0.0)
    q_np = np.asarray(j_q)
    top2 = np.sort(q_np, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4     # no near tie to flip
    assert clear.sum() >= 12
    assert (act.numpy()[clear] == np.asarray(j_act)[clear]).all()
    assert_close(q, q_np, "deepq Q")
    assert_close(val, j_val, "deepq max Q")
    assert not neglogp.any()
    # eps = 1: every action from the generator, within the action set
    act = t_step(torch.as_tensor(obs), gen, eps=1.0)[0]
    assert ((act >= 0) & (act < N_ACT[game])).all()


def test_acer_value_is_expected_q():
    name, alg, network, game = FEEDFORWARD[5]
    obs = _obs(2)
    params = _jax_params(name, alg, network, game)
    _, j_step = j_build_eval_policy(alg, (84, 84, 4), N_ACT[game], network)
    _, j_val, _, j_logits = j_step(params, obs, jax.random.PRNGKey(0))
    module, t_step = build_eval_policy(alg, (84, 84, 4), N_ACT[game],
                                       network, device="cpu")
    module.load_state_dict(load_eval_params(
        alg, network, f"models/{name}.model", game,
        device="cpu").state_dict())
    _, val, _, logits = t_step(torch.as_tensor(obs),
                               torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits2, q = module(torch.as_tensor(obs))
    assert q.shape == (N, N_ACT[game])
    assert torch.equal(val, expected_q(logits2, q))
    assert_close(val, j_val, "acer E_pi[Q]")
    assert_close(logits, j_logits, "acer logits")
    manual = (torch.softmax(logits2, -1) * q).sum(-1)
    assert torch.allclose(val, manual)
    assert not torch.allclose(val, q.max(-1).values)


@pytest.mark.parametrize("name,alg,network,game", RECURRENT,
                         ids=[c[0] for c in RECURRENT])
def test_recurrent_head_matches_jax_at_every_step(name, alg, network, game):
    params = _jax_params(name, alg, network, game)
    apply = jax.jit(_jax_module(alg, network, N_ACT[game]).apply)
    module = load_eval_params(alg, network, f"models/{name}.model", game,
                              device="cpu")
    done = np.zeros((T, N), bool)
    done[DONE_AT, 1] = True
    j_carry = (jnp.zeros((N, 128)), jnp.zeros((N, 128)))
    t_carry = module.initial_carry(N)
    for t in range(T):
        obs = _obs(10 + t)
        j_out = apply(params, obs, j_carry, done[t])
        j_carry = j_out[2]
        with torch.no_grad():
            t_out = module(torch.as_tensor(obs), t_carry,
                           torch.as_tensor(done[t]))
        t_carry = t_out[2]
        for what, g, w in (("logits", t_out[0], j_out[0]),
                           ("value", t_out[1], j_out[1]),
                           ("c", t_carry[0], j_carry[0]),
                           ("h", t_carry[1], j_carry[1])):
            assert_close(g, w, f"{name} {what} at t={t}")
        if t == DONE_AT:
            # the done env restarted from a zero carry
            with torch.no_grad():
                fresh = module(torch.as_tensor(obs[1:2]),
                               module.initial_carry(1),
                               torch.zeros(1, dtype=torch.bool))[2]
            for g, w in zip(t_carry, fresh):
                assert_close(g[1], w[0], f"{name} restarted carry")
                assert not torch.allclose(g[0], w[0])


def test_bf16_trunk_matches_jax_bf16():
    """The bf16 dtype option (f32 parameters, bf16 compute) against JAX's
    NatureCNN(dtype=bfloat16) on Breakout.ppo_bf16's trunk."""
    obs = _obs()
    params = _jax_params("Breakout.ppo_bf16", "ppo", "cnn", "breakout")
    trunk = {"params": params["params"]["trunk"]}
    want = get_network_builder("cnn")(dtype="bfloat16").apply(trunk, obs)
    assert want.dtype == jnp.float32
    f32 = load_eval_params("ppo", "cnn", "models/Breakout.ppo_bf16.model",
                           "breakout", device="cpu").trunk
    bf16 = NatureCNN(dtype="bfloat16")
    bf16.load_state_dict(f32.state_dict())
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    with torch.no_grad():
        got = bf16(torch.as_tensor(obs))
        full = f32(torch.as_tensor(obs))
    assert got.dtype == torch.float32
    assert_close(got, want, "bf16 trunk", scale=4 * 2.0 ** -8)
    # it computes in bf16: every output is a bf16 value, unlike f32's
    assert torch.equal(got, got.to(torch.bfloat16).float())
    assert not torch.equal(full, full.to(torch.bfloat16).float())


def test_alg_network_defaults_equal_jax():
    from toybox_tpu.run import ALG_DEFAULTS as J_DEFAULTS
    from toybox_tpu_torch.run import ALG_DEFAULTS, default_network

    assert set(ALG_DEFAULTS) == set(J_DEFAULTS)
    for alg, spec in J_DEFAULTS.items():
        spec = J_DEFAULTS[spec] if isinstance(spec, str) else spec
        assert default_network(alg) == spec.get("network", "cnn"), alg
