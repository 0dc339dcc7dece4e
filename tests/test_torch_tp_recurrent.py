"""Tensor parallelism along ``model`` for the hybrid (hymba) and SSM
(xLSTM) families against the JAX package, in a gloo group of 8 ranks on
the CPU of its own (``_torch_port.DIST_GROUPS["tp_recurrent"]``): two
mesh steps on (2, 4) data/model against the reference's whole-batch step,
and the forward, the prompt and four decode steps against the port's plain
path.  The checks are those of ``test_torch_distributed.py``
(:func:`check_tp_step`, :func:`check_tp_decode`); the group is a file of
its own so that neither file holds as many tests as
``tests/test_oracle.py`` (ROADMAP "Time budget").
"""
import numpy as np
import pytest

import _torch_port
from _torch_port import fast_reference_compiles  # noqa: F401
from test_torch_distributed import check_tp_decode, check_tp_step, run_ranks

# The two steps' update of each shard against the reference's whole-batch
# step, in relative norm (STEP_TOL also holds them).  A sound run's
# largest: hymba 3.6e-4 (blocks.1.mlp.w1.w; its Mamba weights at most
# 2.6e-4), xLSTM 5.0e-5 (blocks.0.w_down.w).  Faults planted in a scratch
# copy were 1.3 to 1.7 off: z taken from the rank's own block of hymba's
# w_in (blocks.1.mamba.d_skip 1.67), w_bc's partial sums not reduced
# (blocks.2.mamba.dt_bias 1.38), w_if's not reduced (blocks.0.wk 1.30).
TP_CASES = {"tp_hymba": ("hymba-1.5b", {}, 1e-3),
            "tp_xlstm": ("xlstm-1.3b", {}, 5e-4)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the ``tp_recurrent`` group's checks and the
    inputs they read: a batch of 4 x 16 tokens and a prompt of 2 x 24
    (within xLSTM's smoke vocabulary of 128), and the plain path's decode
    runs (made here once)."""
    work = tmp_path_factory.mktemp("dist_recurrent")
    rng = np.random.default_rng(1)
    inp = {"tokens": rng.integers(0, 128, (4, 16)).astype(np.int32),
           "prompt": rng.integers(0, 128, (2, 24)).astype(np.int32)}
    inp["tp_plain"] = _torch_port.tp_plain_runs(
        inp["prompt"], inp["tokens"], _torch_port.TP_RECURRENT)
    return run_ranks(work, inp, "tp_recurrent"), inp, work


@pytest.mark.parametrize("check", list(TP_CASES))
def test_tp_step_matches_reference(ranks, check):
    """Two tensor-parallel steps on (2, 4) against the reference's
    whole-batch step (``check_tp_step``): hymba (over model 4 ranks 0-1
    hold only xm's columns of each ``mamba.w_in`` and ranks 2-3 only z's;
    25 heads' smoke counterpart, 4 q over 2 kv heads, gathers its kv
    columns) and xLSTM (2 heads over 4 ranks: each rank computes the whole
    head its channels fall in; ``r`` stays whole)."""
    check_tp_step(ranks, check, *TP_CASES[check])


@pytest.mark.parametrize("arch", list(_torch_port.TP_RECURRENT))
def test_tp_forward_and_decode_match_plain(ranks, arch):
    """``forward(last_only=True)``'s logits, the prompt's logits (through
    decode steps after hymba's meta tokens) and four decode steps'
    tensor-parallel on (2, 4) within DECODE_TOL of the plain path, the
    decode states on the rank's channels and heads; each rank's copy
    holds each ``model``-split weight as its quarter."""
    out, inp, _ = ranks
    check_tp_decode([o["tp_recurrent_decode"] for o in out], inp["tp_plain"],
                    {arch: _torch_port.TP_RECURRENT[arch]})


def test_decode_states_hold_the_ranks_heads(ranks):
    """The decode states of the tensor-parallel runs: hymba's conv and SSM
    states hold a quarter of d_inner a rank, xLSTM's mLSTM and sLSTM
    states the one whole head that covers the rank's channels (of 2)."""
    out, _, _ = ranks
    for o in out:
        shapes = o["tp_recurrent_decode"]
        hy, xl = shapes["hymba-1.5b"]["state_shapes"], \
            shapes["xlstm-1.3b"]["state_shapes"]
        assert hy[0] == {"conv": (2, 3, 32), "state": (2, 32, 4)}, hy[0]
        assert xl[0] == [(2, 1, 32, 32), (2, 1, 32), (2, 1)], xl[0]
        assert xl[2] == [(2, 32)] * 4, xl[2]
