"""The static auditor (twin of ``repro.analysis``): the port's registered
``(family, impl, policy)`` surfaces judged from ``make_fx`` graphs over
fake tensors, and its Python and CUDA sources judged directly.  Nothing it
does launches a kernel or allocates device memory.  ``python -m
repro_torch.analysis`` is its command line.  The cost model of
``repro.analysis.hlo_cost`` comes with the port's dry-run."""

from repro_torch.analysis.auditor import (  # noqa: F401
    apply_baseline,
    audit_all,
    audit_execution_policy,
    audit_family,
    audit_impl,
    default_baseline_path,
    load_baseline,
    save_baseline,
)
from repro_torch.analysis.rules import RULES, Finding, make_finding  # noqa: F401
from repro_torch.analysis.source_rules import scan_cuda_source, scan_source  # noqa: F401
