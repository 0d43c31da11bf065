"""The paper's primary contribution: waste-quantified interception handling
(Eqs. 1-5), budgeted/pipelined swap, chunked recomputation, and the
min-waste iteration-level scheduler."""
from repro_torch.core import waste                                    # noqa: F401
from repro_torch.core.costmodel import CostModel                      # noqa: F401
from repro_torch.core.estimator import DurationEstimator              # noqa: F401
from repro_torch.core.policy import (BREAKDOWN, INFERCEPT,            # noqa: F401
                               INFERCEPT_ORACLE, IMPROVED_DISCARD, POLICIES,
                               PRESERVE, SWAP, VLLM, PolicyConfig)
from repro_torch.core.request import (Interception, Phase, Request,   # noqa: F401
                                Segment)
from repro_torch.core.scheduler import (IterationPlan, Scheduler,     # noqa: F401
                                  SchedulerStats)
