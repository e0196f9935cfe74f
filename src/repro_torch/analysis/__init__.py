"""repro_torch.analysis: the reference's analysis rules restated for what
exists on one H100. Stands for ``repro/analysis``.

The reference traces its entry points to jaxprs and HLO; the port records
what actually runs (``kernels.calls.record_calls``: every kernel entry
point's call, kernel or plain version, route, shapes and dtypes, and
whether the forward-AD region was open) and reads the built libraries'
resources (``cuobjdump``) and the launches' blocks and shared memory
(``torch.profiler``). Six rules:

  tangent-materialization  the fused route reaches the site through ONE
                           contraction epilogue that writes no (K,)+y stack
  smem-budget              every kernel instantiation fits the H100's shared
                           memory, registers, no local memory, no stack
  transpose-reachability   reverse mode outside forward_ad_region() calls no
                           kernel
  donation                 carried buffers (KV caches, the frozen base) are
                           written in place, not copied
  dtype-policy             fp32 contraction accumulators, no half-precision
                           tensor-core accumulator, wire dtypes as declared
  telemetry-neutrality     telemetry on runs the same calls, bitwise

CLI:  PYTHONPATH=src python -m repro_torch.analysis.lint [--strict] [--quick]
          [--device cpu] [--json PATH]

Not ported: the reference's ``hlo_analysis`` (and ``launch/dryrun``,
``mesh``, ``specs``, ``models/partitioning``) lower programs to 512-chip
TPU SPMD, which has no meaning on one H100.
"""
from repro_torch.analysis.kernel_calls import (
    assert_no_tangent_stack,
    calls,
    kernel_family,
    kernel_name,
    record_calls,
    tangent_stack_outputs,
    tangent_stack_size,
)
from repro_torch.analysis.rules import DONATION_WAIVERS, RULES, Finding
from repro_torch.analysis.smem import (
    BUDGET,
    KERNEL_ROWS,
    card_table,
    smem_table,
)

__all__ = [
    "BUDGET",
    "DONATION_WAIVERS",
    "Finding",
    "KERNEL_ROWS",
    "RULES",
    "assert_no_tangent_stack",
    "calls",
    "card_table",
    "kernel_family",
    "kernel_name",
    "record_calls",
    "smem_table",
    "tangent_stack_outputs",
    "tangent_stack_size",
]
