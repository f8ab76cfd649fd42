"""Every parameter of the JAX package's public functions in the port.

An ``ast`` walk (no imports) over every pair of same-path modules, one
case a pair: for every public top-level function, and every public method
and ``__init__`` of every public class, present in both modules, each JAX
parameter name is
- a port parameter of the same name, or
- covered by the port's ``*args`` (a positional JAX parameter) or
  ``**kwargs``, or
- in RENAMED (the port's name and the idiom that renames it) or
  SUPERSEDED (why the port needs no such parameter), each entry citing
  the ROADMAP.md hazard it follows ("signatures" lists the idioms).

An entry whose function or parameter is gone from the JAX module, or
whose parameter the port has under the JAX name after all, is stale and
fails its module's case.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "toybox_tpu", ROOT / "toybox_tpu_torch"

_ENGINES = ("amidar", "breakout", "gridworld", "space_invaders")
_STATE_FNS = ("lives", "query", "render", "score", "state_to_json", "step")

#: (module, function, JAX parameter) -> (port parameter, ROADMAP idiom)
RENAMED = {
    **{(f"games/{g}.py", fn, "state"): ("s", "signatures: engine arguments")
       for g in _ENGINES for fn in _STATE_FNS},
    **{(f"games/{g}.py", "new_game", "seed"):
       ("seeds", "signatures: engine arguments") for g in _ENGINES},
    ("games/breakout.py", "bricks_remaining", "state"):
        ("s", "signatures: engine arguments"),
    ("games/breakout.py", "channel_count", "state"):
        ("s", "signatures: engine arguments"),
    ("games/common.py", "luma2d", "rgba_img"):
        ("rgba", "signatures: engine arguments"),
    ("games/common.py", "to_grayscale", "rgba_img"):
        ("rgba", "signatures: engine arguments"),
    ("parallel/mesh.py", "mesh_moments", "axis_name"):
        ("mesh", "signatures: collectives"),
    ("regress.py", "play_games", "params"):
        ("state_dict", "signatures: weights"),
    **{("rl/distributions.py", f"{pd}.sample", "key"):
       ("generator", "signatures: draws")
       for pd in ("BernoulliPd", "CategoricalPd", "DiagGaussianPd",
                  "MultiCategoricalPd")},
    ("rl/dqn.py", "replay_sample", "key"): ("noise", "signatures: draws"),
    ("rl/eval_adapter.py", "make_tb_policy", "params"):
        ("state_dict", "signatures: weights"),
    ("rl/kfac.py", "kfac_inverse_shapes", "params"):
        ("module", "signatures: weights"),
    ("rl/models.py", "LSTMTrunk.initial_carry", "batch"):
        ("n", "signatures: engine arguments"),
    ("rl/ppo.py", "load_params", "template"):
        ("module", "signatures: weights"),
    ("rl/ppo.py", "save_params", "params"): ("module", "signatures: weights"),
    ("rl/trpo.py", "trust_region_update", "pi_mod"):
        ("module", "signatures: weights"),
    **{("sample_tests/runner.py", fn, "params"):
       ("state_dict", "signatures: weights")
       for fn in ("play_batched", "run_all_gated", "run_scenario")},
    ("utils/checkpoint.py", "load_checkpoint", "template"):
        ("state", "signatures: weights"),
}

#: (module, function, JAX parameter) -> why the port has no counterpart
SUPERSEDED = {
    ("rl/acktr.py", "KfacCNNPolicy.layer_meta", "image_obs"):
        "signatures: weights (the module is built for its obs shape and "
        "holds whether it has convolutions)",
    ("rl/dqn.py", "replay_sample", "batch_size"):
        "signatures: draws (the batch is the fed noise's first dimension)",
    ("rl/eval_adapter.py", "make_tb_policy", "greedy_key"):
        "signatures: unread (JAX's make_tb_policy never reads it)",
    ("rl/kfac.py", "kfac_factors", "intermediates"):
        "hazards: K-FAC's taps (the port's taps_a)",
    ("rl/kfac.py", "kfac_factors", "perturb_grads"):
        "hazards: K-FAC's taps (the port's taps_g)",
    ("rl/kfac.py", "kfac_precondition", "intermediates"):
        "hazards: K-FAC's taps (the port's taps_a)",
    ("rl/kfac.py", "kfac_precondition", "perturb_grads"):
        "hazards: K-FAC's taps (the port's taps_g)",
    ("rl/models.py", "LSTMTrunk.initial_carry", "nlstm"):
        "signatures: weights (the trunk's own width, self.nlstm)",
    ("rl/trpo.py", "trust_region_update", "pi_params"):
        "signatures: weights (the module holds them, stepped in place)",
}


class _Sig:
    """One function's parameter names (self and cls left out) and
    whether it takes ``*args`` and ``**kwargs``."""

    def __init__(self, args: ast.arguments):
        self.positional = [a.arg for a in args.posonlyargs + args.args
                           if a.arg not in ("self", "cls")]
        self.names = self.positional + [a.arg for a in args.kwonlyargs]
        self.varargs, self.kwargs = args.vararg is not None, \
            args.kwarg is not None

    def covers(self, name: str, positional: bool) -> bool:
        return (name in self.names or self.kwargs
                or (positional and self.varargs))


def _signatures(path: Path) -> dict:
    """{function or Class.method: _Sig} of a module's public top-level
    functions and its public classes' public methods and __init__."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        if isinstance(node, ast.ClassDef):
            for m in node.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (m.name == "__init__"
                             or not m.name.startswith("_"))):
                    out[f"{node.name}.{m.name}"] = _Sig(m.args)
        else:
            out[node.name] = _Sig(node.args)
    return out


PAIRS = sorted(p.relative_to(JAX_PKG).as_posix()
               for p in JAX_PKG.rglob("*.py")
               if (PORT_PKG / p.relative_to(JAX_PKG)).exists())


@pytest.mark.parametrize("rel", PAIRS)
def test_every_jax_parameter_has_its_counterpart(rel):
    jax_sigs = _signatures(JAX_PKG / rel)
    port_sigs = _signatures(PORT_PKG / rel)
    missing = []
    for fn in sorted(set(jax_sigs) & set(port_sigs)):
        jsig, psig = jax_sigs[fn], port_sigs[fn]
        for name in jsig.names:
            key = (rel, fn, name)
            if key in RENAMED:
                assert name not in psig.names, f"stale RENAMED {key}"
                assert RENAMED[key][0] in psig.names, (
                    f"RENAMED {key}: the port has no {RENAMED[key][0]!r}")
            elif key in SUPERSEDED:
                assert name not in psig.names, f"stale SUPERSEDED {key}"
            elif not psig.covers(name, name in jsig.positional):
                missing.append((fn, name))
    assert not missing, f"{rel}: JAX parameters the port lacks: {missing}"
    for table in (RENAMED, SUPERSEDED):
        for r, fn, name in table:
            if r == rel:
                assert fn in jax_sigs and fn in port_sigs and \
                    name in jax_sigs[fn].names, f"stale entry {(r, fn, name)}"


def test_every_table_entry_names_a_module_pair():
    stale = {r for r, _, _ in (*RENAMED, *SUPERSEDED)} - set(PAIRS)
    assert not stale, f"entries for modules that are no pair: {stale}"
    assert all(why.startswith(("signatures: ", "hazards: "))
               for why in [*SUPERSEDED.values(),
                           *(idiom for _, idiom in RENAMED.values())])
