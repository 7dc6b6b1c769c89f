"""Rule catalogue and finding model for the static auditor (twin of
``repro.analysis.rules``).

Every check has a stable rule ID, the contract with baselines, logs and
the mutation tests in ``tests/test_torch_analysis.py`` (each ID there is
proven live by a seeded violation).  The IDs and severities are
``repro``'s; the groups follow the contract families:

  AUD  plumbing     a declared surface fails to trace at all
  PRE  precision    f32 accumulation / pass-count / downcast structure
  CAP  capability   vjp / decode claims, fused-vs-router decomposition
  SHD  sharding     declared ``Partitioning`` collectives vs the ones a
                    sharded trace issues (nothing undeclared, nothing
                    declared but never observed, f32 reductions in f32)
  PAL  kernels      split ranges and tile origins, tile divisibility,
                    accumulator dtypes, no plain version on the card
  SRC  source       raw contractions without an f32 accumulator, in the
                    Python sources and in the CUDA sources

A ``Finding`` is one violation at one target; its ``key``
(``rule_id|target``) is what baseline suppressions match, so a
suppression pins one rule at one (family, impl, policy[#surface][@mesh])
coordinate and nothing else.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Finding", "Rule", "RULES", "rule", "make_finding"]


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    severity: str                # "error" | "warning"
    title: str


RULES: dict[str, Rule] = {r.rule_id: r for r in (
    Rule("AUD001", "error",
         "declared surface fails to trace (make_fx raised)"),
    Rule("PRE001", "error",
         "tensor-core contraction does not accumulate in f32 (aten "
         "contraction output narrower than float32)"),
    Rule("PRE002", "error",
         "decomposition pass count differs from the policy's declared "
         "rung count (contractions != num_passes * contraction sites)"),
    Rule("PRE003", "error",
         "contraction output downcast below f32 before accumulation "
         "(narrowing _to_copy between multiply and add)"),
    Rule("CAP001", "error",
         "impl declares 'vjp' but its backward fails to trace"),
    Rule("CAP002", "error",
         "declared decode-class capability fails to trace"),
    Rule("CAP003", "error",
         "fused/router decomposition structure contradicts "
         "fused_policies (kernel-launch count vs declared fusion)"),
    Rule("SHD001", "error",
         "sharded trace performs a collective the impl's Partitioning "
         "does not declare"),
    Rule("SHD002", "error",
         "declared Partitioning collective never observed on any audit "
         "mesh"),
    Rule("SHD003", "error",
         "collective declared *_f32 reduces a non-f32 operand"),
    Rule("PAL001", "error",
         "split range or tile origin leaves the operand's tile grid at a "
         "grid corner (or a split range is empty)"),
    Rule("PAL002", "error",
         "tile does not divide the operand where the kernel takes whole "
         "tiles only"),
    Rule("PAL003", "error",
         "floating-point accumulator or split-K workspace narrower than "
         "f32 (a kernel site, or a wgmma / mma / wmma form in the CUDA "
         "sources)"),
    Rule("PAL004", "error",
         "cuda route reached the kernel's plain version instead of its "
         "kernel"),
    Rule("SRC001", "error",
         "torch contraction without f32 operands or out_dtype=torch.float32"),
)}


def rule(rule_id: str) -> Rule:
    return RULES[rule_id]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one audit target."""

    rule_id: str
    severity: str
    target: str                  # "family/impl/policy[#surface]" or "file:line"
    message: str

    @property
    def key(self) -> str:
        """The baseline-suppression coordinate (message-independent, so
        rewording a rule never invalidates a reviewed suppression)."""
        return f"{self.rule_id}|{self.target}"

    def as_dict(self) -> dict[str, str]:
        return {"rule": self.rule_id, "severity": self.severity,
                "target": self.target, "message": self.message,
                "key": self.key}

    def __str__(self) -> str:
        return f"{self.severity.upper()} {self.rule_id} {self.target}: " \
               f"{self.message}"


def make_finding(rule_id: str, target: str, message: str) -> Finding:
    r = RULES[rule_id]
    return Finding(rule_id=r.rule_id, severity=r.severity, target=target,
                   message=message)
