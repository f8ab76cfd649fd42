"""The port's GAIL expert pipeline (toybox_tpu_torch.rl.gail
``generate_expert_dataset``, ``save_expert_dataset``,
``load_expert_dataset``) against the JAX package's.

- Extraction from the committed ``models/Breakout.regress.model`` on a
  4-env Breakout pipeline (tests/test_harnesses.py:237-249 in both
  packages), 32 transitions at stride 1 and stride 3, fed JAX's draws
  replayed with its key schedule (the env seeds from the first split,
  then a split an agent step, the actions argmax(logits + gumbel)): the
  same actions, and the same observations (the two pipelines' warps may
  differ by 1 grey level, tests/test_torch_pipeline.py).
- The npz files across packages: written by the port and read by JAX,
  and the other way round, equal arrays and dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_codecs import one_torch_thread  # noqa: F401
from toybox_tpu.envs.pipeline import make_rl_env as j_make_rl_env
from toybox_tpu.rl import gail as jgail
from toybox_tpu_torch.envs.pipeline import make_rl_env as t_make_rl_env
from toybox_tpu_torch.rl import gail

MODEL = "models/Breakout.regress.model"
NENVS, N = 4, 32


def _jax_draws(stride: int, n_actions: int, seed: int = 0) -> dict:
    key, ekey = jax.random.split(jax.random.PRNGKey(seed))
    seeds = jax.random.randint(ekey, (NENVS,), 0, 2**31 - 1).astype(
        jnp.uint32)
    noise = []
    for _ in range(-(-N // NENVS) * stride):
        key, akey = jax.random.split(key)
        noise.append(jax.random.gumbel(akey, (NENVS, n_actions),
                                       jnp.float32))
    return {"seeds": torch.as_tensor(np.asarray(seeds).astype(np.int64)),
            "gumbel": torch.as_tensor(np.array(jnp.stack(noise)))}


@pytest.mark.parametrize("stride", [1, 3])
def test_expert_dataset_matches_jax(stride):
    jenv = j_make_rl_env("breakout", NENVS)
    jobs, jacts = jgail.generate_expert_dataset(
        jenv, load_path=MODEL, n_transitions=N, network="cnn",
        stride=stride)
    tenv = t_make_rl_env("breakout", NENVS, device="cpu")
    obs, acts = gail.generate_expert_dataset(
        tenv, load_path=MODEL, n_transitions=N, network="cnn",
        stride=stride, device="cpu",
        draws=_jax_draws(stride, tenv.num_actions))
    assert obs.shape == jobs.shape == (N, 84, 84, 4)
    assert obs.dtype == jobs.dtype == np.uint8
    assert acts.shape == (N,) and acts.dtype == jacts.dtype
    np.testing.assert_array_equal(acts, jacts)
    diff = np.abs(obs.astype(np.int16) - jobs.astype(np.int16))
    assert int(diff.max()) <= 1, int(diff.max())
    assert len(set(acts.tolist())) > 1      # the policy's draws, not one


def test_expert_npz_round_trips_across_packages(tmp_path):
    r = np.random.default_rng(0)
    obs = r.integers(0, 256, (6, 84, 84, 4)).astype(np.uint8)
    acts = r.integers(0, 4, 6).astype(np.int32)
    gail.save_expert_dataset(tmp_path / "port.npz", obs, acts)
    jgail.save_expert_dataset(tmp_path / "jax.npz", obs[::-1], acts[::-1])
    for (o, a), (wo, wa) in (
            (jgail.load_expert_dataset(tmp_path / "port.npz"), (obs, acts)),
            (gail.load_expert_dataset(tmp_path / "jax.npz"),
             (obs[::-1], acts[::-1]))):
        assert o.dtype == wo.dtype and a.dtype == wa.dtype
        np.testing.assert_array_equal(o, wo)
        np.testing.assert_array_equal(a, wa)
