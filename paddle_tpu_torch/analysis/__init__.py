"""paddle_tpu_torch.analysis — graftlint for the port.

Counterpart of ``paddle_tpu/analysis``: static analysis over the port's
sources and a recorder of what a call dispatches.

* **AST passes over the source tree** (:mod:`.astlint` is the pass
  manager; one module per rule): ``import-guard`` (serving's
  no-new-deps / scoped-network contract), ``port-isolation`` (nothing of
  JAX or the JAX package), ``determinism`` (injectable clock, seeded
  generators, torch's ambient generator included), ``host-sync`` (the
  torch analogue of trace-safety: device-to-host syncs in the functions
  a CUDA graph would capture), ``metrics-docs`` (README metric table ==
  registered families).
* **op audits** (:mod:`.op_audit`): a ``TorchDispatchMode`` recorder of
  the aten ops a call dispatches, with their dtypes, each kernel
  wrapper one event (the counterpart of ``jaxpr_audit``).

Run the linter::

    python -m paddle_tpu_torch.analysis                  # the port, text
    python -m paddle_tpu_torch.analysis --format=json    # machine-readable
    python -m paddle_tpu_torch.analysis --rule host-sync paddle_tpu_torch/kernels
    python -m paddle_tpu_torch.analysis --list-rules

Suppress a finding inline, with its justification::

    deadline = time.time() + 60  # graftlint: allow=determinism — host poll

``tests/test_torch_analysis.py`` runs the whole suite over the port and
fails on any unsuppressed finding.
"""

from .astlint import (Finding, Project, Rule, SourceModule,  # noqa: F401
                      all_rules, load_project, register, run)

__all__ = ["Finding", "Project", "Rule", "SourceModule",
           "all_rules", "load_project", "register", "run"]
