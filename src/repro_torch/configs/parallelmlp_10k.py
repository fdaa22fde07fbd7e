"""parallelmlp-10k [population] — the paper's own experiment (§4.2).

10,000 independent MLPs fused into one network: hidden sizes 1..100 × the
ten activation functions × 10 repeats, 100 input features, 2 classes.
block=128 gives a fused hidden width of 1,280,000; it serves as a depth-1
``LayeredPopulation`` (``config().model.layered()``)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.core.activations import PAPER_TEN
from repro_torch.core.population import Population

IN_FEATURES = 100
OUT_CLASSES = 2


def config() -> ArchSpec:
    pop = Population.grid(IN_FEATURES, OUT_CLASSES,
                          hidden_range=range(1, 101),
                          activations=PAPER_TEN,
                          repeats=10, block=128)
    return ArchSpec(
        arch_id="parallelmlp-10k", kind="population", model=pop,
        optimizer="sgd", lr=1e-2,
        source="[the reproduced paper, §4.2]",
        notes="10,000 members, total fused hidden = 1,280,000 (128-aligned).")


def reduced() -> ArchSpec:
    pop = Population.grid(10, 3, hidden_range=range(1, 9),
                          activations=("relu", "tanh"), repeats=2, block=8)
    return ArchSpec(arch_id="parallelmlp-10k", kind="population", model=pop,
                    optimizer="sgd", lr=1e-2)
