"""The port's tuning harness and config files held against the JAX
package's: SPSA theta trajectories and GSPRT LLRs equal for the same seed
and results; `config_from_theta` equal; one `EngineTuner.tune` step with
an exact stub network on 9x9 (golden `tuner_step`: the match score and
theta equal) and a capped GSPRT gate; `utils/configs.py` dicts equal, and
a `config.json` written by either package read back by the other.
"""

import json

import numpy as np
import pytest
import torch

from alphagomoku_tpu_torch.eval import gsprt as TGS
from alphagomoku_tpu_torch.eval import spsa as TSP
from alphagomoku_tpu_torch.eval import tuner as TTU
from alphagomoku_tpu_torch.game import vectorized as TV
from alphagomoku_tpu_torch.game.types import GameRules
from alphagomoku_tpu_torch.models.networks import NetOutput
from alphagomoku_tpu_torch.search import mcts as TM
from alphagomoku_tpu_torch.selfplay.selfplay import SelfplayConfig
from alphagomoku_tpu_torch.training.train import TrainConfig
from alphagomoku_tpu_torch.utils import configs as TC
from tests import torch_golden

torch.set_num_threads(1)

H = W = 9
PREFERRED = 12
SIMS = 4
GAMES = 4  # games a step: two openings, each played with both colours
BASE = dict(max_nodes=SIMS + 8, max_edges=8, max_depth=6, policy="puct_fpu")


def _stub_tables(seed: int = 31):
    pri = np.random.default_rng(seed).permutation(H * W).astype(np.float32).reshape(H, W)
    ws = np.random.default_rng(seed + 1).integers(-1, 2, size=(H, W)).astype(np.float32)
    return pri, ws


def jax_stub(_, planes):
    """An exact stub (tests/test_torch_match.py's construction at 9x9):
    policy uniform on the 12 preferred empty cells, a one-hot value by the
    sign of a stone weighting."""
    import jax.numpy as jnp
    from alphagomoku_tpu.models.networks import NetOutput as JaxNetOutput

    pri, ws = _stub_tables()
    p = planes.astype(jnp.float32)
    bsz = p.shape[0]
    score = jnp.where(p[..., 1] + p[..., 2] == 0, pri, -1.0).reshape(bsz, -1)
    thr = jnp.sort(score, -1)[:, -PREFERRED]
    s = (p[..., 1] * ws).sum((1, 2)) - (p[..., 2] * ws).sum((1, 2))
    return JaxNetOutput(
        policy_logits=jnp.where(score >= thr[:, None], 0.0, -1e4).reshape(bsz, H, W),
        value_logits=jnp.where(jnp.stack([s > 0, s == 0, s < 0], -1), 0.0, -1e4),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def torch_stub(_, planes):
    pri, ws = (torch.from_numpy(a) for a in _stub_tables())
    p = planes.float()
    bsz = p.shape[0]
    score = torch.where(p[..., 1] + p[..., 2] == 0, pri, -1.0).reshape(bsz, -1)
    thr = torch.sort(score, -1).values[:, -PREFERRED]
    s = (p[..., 1] * ws).sum((1, 2)) - (p[..., 2] * ws).sum((1, 2))
    return NetOutput(
        policy_logits=torch.where(score >= thr[:, None], 0.0, -1e4).reshape(bsz, H, W),
        value_logits=torch.where(torch.stack([s > 0, s == 0, s < 0], -1), 0.0, -1e4),
        q_logits=None, moves_left_logits=None, soft_policy_logits=None,
    )


def jax_tuner_step() -> dict:
    """The golden tuner_step: the JAX package's EngineTuner (seed 2) at 4
    sims, 4 games a step on 9x9, one SPSA step with the match's gradient
    recorded."""
    from alphagomoku_tpu.eval import tuner as JTU
    from alphagomoku_tpu.search import mcts as JM
    from tests.test_torch_mcts import jax_tables

    tuner = JTU.EngineTuner(jax_stub, None, jax_tables(GameRules.FREESTYLE),
                            JM.MCTSConfig(**BASE), num_simulations=SIMS, games_per_step=GAMES,
                            rows=H, cols=W, seed=2)
    grads = []
    inner = tuner.spsa.gradient_func
    tuner.spsa.gradient_func = lambda tp, tm: grads.append(inner(tp, tm)) or grads[-1]
    tuner.tune(steps=1)
    return {"theta": tuner.spsa.theta, "grad": np.float64(grads[0]),
            "step": np.int64(tuner.spsa.step)}


def test_tuner_step_matches_jax():
    ref = torch_golden.load("tuner_step")
    tuner = TTU.EngineTuner(torch_stub, None, TV.device_tables(GameRules.FREESTYLE),
                            TM.MCTSConfig(**BASE), num_simulations=SIMS, games_per_step=GAMES,
                            rows=H, cols=W, seed=2, device="cpu")
    grads = []
    inner = tuner.spsa.gradient_func
    tuner.spsa.gradient_func = lambda tp, tm: grads.append(inner(tp, tm)) or grads[-1]
    cfg = tuner.tune(steps=1)
    assert grads[0] == float(ref["grad"]) and tuner.spsa.step == int(ref["step"])
    assert np.array_equal(tuner.spsa.theta, ref["theta"])
    assert cfg == TTU.config_from_theta(tuner.base, tuner.params, ref["theta"])
    # the gate, capped at 2 pairs: a decided or undecided GSPRT status
    assert tuner.gate(cfg, max_pairs=2) in (-1, 0, 1)


def test_config_from_theta_matches_jax():
    from alphagomoku_tpu.eval import tuner as JTU
    from alphagomoku_tpu.search import mcts as JM

    for theta in ([0.0, 1.0, 0.5], [0.3, 0.7, 1.2], [-0.1, 0.25, 0.9]):
        want = JTU.config_from_theta(JM.MCTSConfig(), JTU.DEFAULT_PARAMS, theta)
        got = TTU.config_from_theta(TM.MCTSConfig(), TTU.DEFAULT_PARAMS, theta)
        assert got._asdict() == want._asdict()
    assert [(p.name, p.low, p.high) for p in TTU.DEFAULT_PARAMS] == \
        [(p.name, p.low, p.high) for p in JTU.DEFAULT_PARAMS]


@pytest.mark.parametrize("mode", ["func", "gradient"])
def test_spsa_trajectory_equal(mode):
    from alphagomoku_tpu.eval import spsa as JSP

    target = np.array([0.2, 0.9, 0.6])
    f = lambda th: -float(((np.asarray(th) - target) ** 2).sum())
    g = lambda tp, tm: f(tp) - f(tm)
    kw = dict(func=f) if mode == "func" else dict(gradient_func=g)
    j = JSP.SPSA(None if mode == "gradient" else kw["func"], 3,
                 gradient_func=kw.get("gradient_func"), seed=11)
    t = TSP.SPSA(None if mode == "gradient" else kw["func"], 3,
                 gradient_func=kw.get("gradient_func"), seed=11)
    for _ in range(25):
        assert j.do_one_step(25) == t.do_one_step(25)
        assert np.array_equal(j.theta, t.theta)
    assert j.save_progress() == t.save_progress()
    t2 = TSP.SPSA(f, 3)
    t2.load_progress(json.loads(json.dumps(j.save_progress())))
    assert np.array_equal(t2.theta, j.theta) and t2.step == 25


def test_gsprt_llr_equal():
    from alphagomoku_tpu.eval import gsprt as JGS

    rng = np.random.default_rng(4)
    for elo1, p in ((10.0, [0.1, 0.2, 0.3, 0.25, 0.15]), (5.0, [0.3, 0.2, 0.2, 0.2, 0.1])):
        j, t = JGS.GSPRT(0.0, elo1), TGS.GSPRT(0.0, elo1)
        for pts in rng.choice(5, size=300, p=p):
            assert j.add_result(int(pts)) == t.add_result(int(pts))
            assert j.llr == t.llr
        assert j.results == t.results and (j.lower, j.upper) == (t.lower, t.upper)
    penta = [3, 5, 9, 6, 2]
    j, t = JGS.GSPRT(0.0, 10.0), TGS.GSPRT(0.0, 10.0)
    assert j.add_pentanomial(penta) == t.add_pentanomial(penta) and j.llr == t.llr


def test_config_dicts_equal_to_jax():
    from alphagomoku_tpu.search.mcts import MCTSConfig as JMCfg
    from alphagomoku_tpu.selfplay.selfplay import SelfplayConfig as JSCfg
    from alphagomoku_tpu.training.train import TrainConfig as JTCfg
    from alphagomoku_tpu.utils import configs as JC

    for jcls, tcls in ((JMCfg, TM.MCTSConfig), (JSCfg, SelfplayConfig), (JTCfg, TrainConfig)):
        assert TC.to_dict(tcls()) == JC.to_dict(jcls())
        over = TC.to_dict(tcls())
        back = TC.from_dict(tcls, {**over, "bogus": 1})
        assert back == tcls()
    cfg = TM.MCTSConfig(max_nodes=512, policy="kl_ucb", leaf_batch=4, init_to="q_head")
    assert TC.to_dict(cfg) == JC.to_dict(JMCfg(**TC.to_dict(cfg)))
    assert TC.default_master_config() == JC.default_master_config()
    assert TC.CONFIG_VERSION == JC.CONFIG_VERSION


def test_config_files_cross_load(tmp_path):
    from alphagomoku_tpu.utils import configs as JC

    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jcfg = JC.load_master_config(jpath)  # created with the defaults
    tcfg = TC.load_master_config(tpath)
    assert open(jpath).read() == open(tpath).read()
    jcfg["search"]["leaf_batch"] = 4
    jcfg["search"]["policy"] = "thompson"
    JC.save_master_config(jcfg, jpath)
    assert TC.load_master_config(jpath) == jcfg
    search = TC.from_dict(TM.MCTSConfig, TC.load_master_config(jpath)["search"])
    assert search.leaf_batch == 4 and search.policy == "thompson"
    tcfg["training"]["learning_rate"] = 3e-4
    TC.save_master_config(tcfg, tpath)
    assert JC.load_master_config(tpath) == tcfg
    tcfg["version"] = "0.0"
    TC.save_master_config(tcfg, tpath)
    for mod in (TC, JC):
        with pytest.raises(ValueError, match="version mismatch"):
            mod.load_master_config(tpath)
