"""The search layer on top of the halving lifecycle: a declarative
hyperparameter / architecture space (``space.SearchSpace``) and the
slot-refill controller (``controller.RefillController``), the port's own
copies of the JAX package's ``repro.search``."""
from repro_torch.search.controller import (RefillController, RefillMember,
                                           RefillPlan)
from repro_torch.search.space import DEFAULT_SPACE, SearchSpace

__all__ = ["DEFAULT_SPACE", "RefillController", "RefillMember",
           "RefillPlan", "SearchSpace"]
