"""smollm-360m's training run with its whole vocabulary on both packages,
at a small width (2 layers, d_model 64): the head keeps all 49 152
tokens and the synthetic stream draws over all of them.

This is the stream ``chip_smoke.py``'s ``[train]`` phase was first asked
to learn from at full width.  It has 768 token ids a planted class, so in
30 steps of a few thousand tokens each id occurs only a handful of times;
the point here is that the two packages agree on such a run, step by
step, whether the loss falls or not.
"""
import jax
import numpy as np

from repro.configs import base as RC
from repro.data import DataConfig as RefDataConfig, SyntheticLM as RefData
from repro.models import build as ref_build
from repro.optim import OptConfig as RefOptConfig
from repro.train import TrainConfig as RefTrainConfig, Trainer as RefTrainer
from repro_torch.configs import base as PC
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models import build, params_from_jax
from repro_torch.optim import OptConfig, opt_state_from_jax
from repro_torch.train import TrainConfig, Trainer

from repro.launch.mesh import make_host_mesh

LOSS_RUN = 1e-3           # every step's loss, relative
_OPT = dict(lr=3e-3, warmup_steps=5, total_steps=60)


def _mesh():
    return make_host_mesh((1, 1), ("data", "model"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_full_vocabulary_stream_gives_the_reference_curve(tmp_path):
    """smollm-360m's whole 49 152-token vocabulary in the head and in the
    synthetic stream (768 token ids a planted class, so each id occurs a
    few times in 30 steps), at a small width: both packages give the same
    30 losses (within 1e-3 relative), learning or not."""
    over = dict(n_layers=2, d_model=64, vocab=49152, d_ff_scale=32)
    rcfg = RC.reduced(RC.get("smollm-360m"), **over)
    pcfg = PC.reduced(PC.get("smollm-360m"), **over)
    data = dict(vocab=49152, seq_len=16, global_batch=4, seed=0)
    ref = RefTrainer(ref_build(rcfg, _mesh()), RefOptConfig(**_OPT),
                     RefTrainConfig(ckpt_every=10 ** 6,
                                    ckpt_dir=str(tmp_path / "ref")),
                     RefData(RefDataConfig(**data)))
    init = _np(ref.init_state(jax.random.PRNGKey(0)))
    want = ref.run(30)
    port = Trainer(build(pcfg, device="cpu"), OptConfig(**_OPT),
                   TrainConfig(ckpt_every=10 ** 6,
                               ckpt_dir=str(tmp_path / "port")),
                   SyntheticLM(DataConfig(**data)))
    port.state = {"params": params_from_jax(init["params"], device="cpu"),
                  "opt": opt_state_from_jax(init["opt"], device="cpu")}
    np.testing.assert_allclose(port.run(30), want, rtol=LOSS_RUN)
