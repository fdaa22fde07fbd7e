"""The port's example twins (``examples/torch_quickstart.py``,
``examples/torch_feature_selection.py``,
``examples/torch_search_population.py``, ``examples/torch_train_lm.py``,
``examples/torch_fault_tolerant_train.py``) run end to end on the CPU
through their ``main``: the quickstart at a tiny size, the
feature-selection example at its own sizes (a few seconds), every masked
w1 entry exactly 0 after every step, the refill search at a reduced
ladder, its one chunk building no table after the first, the LM trainer
at its ``--tiny`` size with microbatches and a checkpoint, and the
fault-tolerance demo at its own (reduced) size, its restarted run
matching the unbroken one."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.launch import launch_count as tlc

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("extra", [[], ["--per-member-lr", "--m3-impl",
                                        "pallas"]])
def test_quickstart(extra, capsys):
    rows = _load("torch_quickstart").main(
        ["--members", "40", "--steps", "5", "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert "trained 40 MLPs × 5 steps" in out and "leaderboard:" in out
    assert len(rows) == 10 and rows[0]["rank"] == 1
    assert all(r["loss"] <= s["loss"] for r, s in zip(rows, rows[1:]))
    if extra:
        assert "per-member learning rates in [0.01, 0.3]" in out


@pytest.mark.parametrize("m3_impl", ["bucketed", "pallas"])
def test_feature_selection(m3_impl, capsys):
    tlc.reset_kernel_launches()
    res = _load("torch_feature_selection").main(
        ["--device", "cpu", "--m3-impl", m3_impl])
    assert res["masked_max_abs"] == 0.0
    assert 0 <= res["recovered"] <= 3 and len(res["top3"]) == 3
    assert "recovered" in capsys.readouterr().out
    m3 = {k: v for k, v in tlc.kernel_launches().items() if v}
    # 150 steps, then the closing forward
    assert m3 == ({"m3_matmul_fwd": 151, "m3_matmul_dh": 150,
                   "m3_matmul_dw": 150} if m3_impl == "pallas" else {})


def test_search_population(capsys):
    tlc.reset_kernel_launches()
    res = _load("torch_search_population").main(
        ["--device", "cpu", "--steps", "12", "--ladder", "4:0.5,8:0.5",
         "--batch", "32", "--samples", "512"])
    out = capsys.readouterr().out
    assert res["chunk_builds"] == 1 and res["tables_rebuilt"] == 0
    # 16 seeds, 8 slots refilled at each of the two rungs
    assert res["explored"] == 32 and "layout unchanged" in out
    assert len(set(res["member_ids"])) == 16
    losses = [r["loss"] for r in res["leaderboard"]]
    assert losses == sorted(losses) and len(losses) == 5
    # 12 fused steps of the depth-2 layout, then the evaluations (each a
    # forward of depth + 1 launches): two rungs and the closing one
    n = {k: v for k, v in tlc.kernel_launches().items() if v}
    assert n["fused_input_bwd"] == 12 and n["loss_head_bwd"] == 12
    assert n["fused_layer_dx_dw"] == 12


@pytest.fixture()
def one_thread():
    """One intra-op thread for the LM examples' many small CPU steps (a
    full thread pool slows them many times over when the test workers
    share the machine's cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_lm(tmp_path, capsys, one_thread):
    from repro_torch.kernels import flash_attn as fak
    f0 = fak.launches
    res = _load("torch_train_lm").main(
        ["--device", "cpu", "--tiny", "--steps", "4", "--batch", "4",
         "--seq", "16", "--num-micro", "2", "--ckpt-every", "2",
         "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "model: qwen3-tiny" in out and "done in" in out
    assert len(res["losses"]) == 4 and len(res["saved"]) == 2
    # 2 layers, 2 microbatches, 4 steps: one flash launch each
    assert fak.launches - f0 == 2 * 2 * 4


def test_fault_tolerant_train(tmp_path, capsys, one_thread):
    res = _load("torch_fault_tolerant_train").main(
        ["--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["restarts"] == 2 and "identical: True" in out
    assert res["ref_loss"] == res["ft_loss"]
    assert res["wire_bytes"] == 4096 + 4 and res["rel_err"] < 0.02
