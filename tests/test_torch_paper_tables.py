"""The port's twin of the paper's Tables 1–2
(``repro_torch/launch/paper_tables.py``) on the CPU, on a tiny grid
(samples 64, features 5, batch 16, 20 models, 1 epoch, seq-sample 3):

  * its parallel arm (``parallel_train``) from numpy parameters against
    the JAX package's ``parallel_mlp.sgd_step`` over the same batches;
  * its sequential arm (``sequential_train``) of each sampled member
    against ``extract_member`` of the parallel state — the independence
    property the paper's speedup rests on;
  * ``main`` prints the JAX bench's 9-column CSV, one row a cell.

Tolerance: rtol 2e-4 / atol 2e-5 (tests/test_independence.py).  Also the
M3 forward's member-to-CTA rule at the paper's own block-1 layout (10,000
members, 505,000 units), which the grid puts on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import parallel_mlp as jpm
from repro.core.activations import PAPER_TEN
from repro.core.population import Population as JPopulation
from repro.data import TabularTask as JTask
from repro_torch.core import parallel_mlp as tpm
from repro_torch.core.population import Population as TPopulation
from repro_torch.data.synthetic import TabularTask
from repro_torch.kernels import infer_head as ihk
from repro_torch.launch import launch_count as tlc
from repro_torch.launch import paper_tables as pt

STEP = dict(rtol=2e-4, atol=2e-5)
SAMPLES, FEATURES, BATCH, MODELS, SEQ_SAMPLE = 64, 5, 16, 20, 3
STEPS = SAMPLES // BATCH   # one epoch


def _pops(block):
    kw = dict(repeats=1, block=block)
    hidden = range(1, MODELS // 10 + 1)
    return (JPopulation.grid(FEATURES, 2, hidden, PAPER_TEN, **kw),
            TPopulation.grid(FEATURES, 2, hidden, PAPER_TEN, **kw))


@pytest.mark.parametrize("m3_impl", ["scatter", "pallas"])
@pytest.mark.parametrize("block", [1, 8])
def test_parallel_and_sequential_arms(block, m3_impl):
    jpop, tpop = _pops(block)
    np_params = jax.device_get(jpm.init_params(jax.random.PRNGKey(0), jpop))
    task = TabularTask(SAMPLES, FEATURES, n_classes=2, seed=1)
    jtask = JTask(SAMPLES, FEATURES, n_classes=2, seed=1)
    jp = np_params
    for step in range(STEPS):
        xb, yb = jtask.batch(step, BATCH)
        jp, _, _ = jpm.sgd_step(jp, jnp.asarray(xb), jnp.asarray(yb), 0.01,
                                jpop, m3_impl="scatter")
    start = tpm.params_from_numpy(np_params, tpop, device="cpu")
    tlc.reset_kernel_launches()
    tp = pt.parallel_train(start, tpop, task, BATCH, STEPS, 0.01, m3_impl)
    m3 = {k: v for k, v in tlc.kernel_launches().items() if v}
    assert m3 == ({k: STEPS * v for k, v in tlc.m3_step_launches().items()}
                  if m3_impl == "pallas" else {})
    for k in tpm.KEYS:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **STEP)
    idx = np.linspace(0, tpop.num_members - 1, SEQ_SAMPLE).astype(int)
    tlc.reset_kernel_launches()
    for m in idx:
        alone = pt.sequential_train(pt.own_member(start, tpop, int(m)), task,
                                    BATCH, STEPS, 0.01)
        fused = tpm.extract_member(tp, tpop, int(m))
        assert alone["activation"] == fused["activation"]
        for k in tpm.KEYS:
            assert alone[k].is_contiguous()
            np.testing.assert_allclose(alone[k].numpy(), fused[k].numpy(),
                                       err_msg=f"member {m} {k}", **STEP)
    assert not any(tlc.kernel_launches().values()), \
        "the sequential arm launched a kernel of the port"


def test_own_member_owns_its_tensors():
    _, tpop = _pops(8)
    params = tpm.init_params(torch.Generator().manual_seed(0), tpop,
                             device="cpu")
    member = pt.own_member(params, tpop, 3)
    for k in tpm.KEYS:
        assert member[k].is_contiguous()
        assert member[k].untyped_storage().data_ptr() != \
            params[k].untyped_storage().data_ptr()
    member["w1"].add_(1.0)
    assert torch.equal(params["w1"][tpop.member_slice(3)] + 1.0,
                       member["w1"])


def test_main_prints_the_csv(capsys):
    rows = pt.main(["--samples", str(SAMPLES), "--features", "5", "7",
                    "--batches", "16", "32", "--models", str(MODELS),
                    "--epochs", "1", "--seq-sample", str(SEQ_SAMPLE),
                    "--block", "8", "--m3-impl", "pallas",
                    "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == pt.HEADER
    assert len(pt.HEADER.split(",")) == 9
    assert len(lines) == 1 + 4 and len(rows) == 4
    cells = set()
    for line, row in zip(lines[1:], rows):
        fields = line.split(",")
        assert len(fields) == 9
        ns, nf, b, p = map(int, fields[:4])
        cells.add((nf, b))
        assert (ns, p) == (SAMPLES, MODELS)
        par, seq, sig, ratio, speedup = map(float, fields[4:])
        assert par > 0 and seq > 0 and sig >= 0
        assert ratio == pytest.approx(100 * row[4] / row[5], rel=1e-3)
        assert speedup == pytest.approx(row[5] / row[4], rel=1e-3)
    assert cells == {(5, 16), (5, 32), (7, 16), (7, 32)}


def test_block1_paper_head_every_member_has_one_owner():
    """The M3 forward at the paper's layout (``--full --block 1``: 10,000
    members of 1-100 units, H 505,000) takes the scalar instance, one lane
    over 256-unit tiles (``head_stream.cuh``'s ``fwd_shape``): every member
    has exactly one owning CTA, in order, and starts in its tile."""
    pop = TPopulation.grid(100, 2, range(1, 101), PAPER_TEN, repeats=10,
                           block=1)
    assert (pop.num_members, pop.total_hidden) == (10_000, 505_000)
    h = torch.empty(2, pop.total_hidden)
    assert ihk.kernel_path(pop.block, h, torch.empty(2, pop.total_hidden)) \
        == "scalar"
    ptr = [int(s) for s in pop.offsets]
    tile, n_tiles = 256, -(-pop.total_hidden // 256)
    owned = [ihk.cta_members(ptr, c, block=1, hidden=pop.total_hidden,
                             tile=tile) for c in range(n_tiles)]
    assert [m for r in owned for m in r] == list(range(pop.num_members))
    for c, r in enumerate(owned):
        assert all(c * tile <= ptr[m] < (c + 1) * tile for m in r)
