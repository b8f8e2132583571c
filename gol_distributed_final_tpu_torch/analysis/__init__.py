"""AST-based invariant checkers — the contracts reviews kept re-enforcing.

Every review-hardening pass in CHANGES.md fixed the same mechanical bug
classes by hand: a ``Request``/``Response`` extension field read without
``getattr`` (version-skew AttributeError on an old peer's pickle), shared
state touched outside its lock (``deque mutated during iteration``,
double-metered SLO transitions), and broad ``except: pass`` blocks that
swallow evidence.
This package turns those informal contracts into machine-checked
invariants: a dependency-free ``ast`` framework (``core.py``) plus one
checker module per bug class, self-hosted over the whole package by
``scripts/check`` (the analyzer must exit clean on every commit).

The README "Static analysis" section is the operator contract: checker
ids, the invariant each enforces, and the suppression syntax
(``# gol: allow(<check>): <justification>`` — the justification is
mandatory and machine-enforced, so the allow-list stays auditable).

Layout:

* ``core.py``    — Finding/Checker framework, file walker, suppressions
  (with staleness tracking), the runner and its exit-code contract
* ``skew.py``    — ``skew-safety``: getattr/.get discipline on wire objects
* ``locks.py``   — ``lock-discipline``: ``_GUARDED_BY`` field/lock contracts
* ``lockorder.py``— whole-program lock composition: ``lock-order``
  acquisition-graph cycles, ``atomicity`` read-release-write TOCTOU,
  ``blocking-under-lock`` blocking calls under hot-path locks
* ``hygiene.py`` — ``hygiene``: daemonised/joined threads, context-managed
  executors, no silent excepts
* ``lints.py``   — the obs/lint.py README name-drift lints, re-seated as
  repo-level checkers (one runner, one finding format, one suppression
  syntax)
* ``__main__.py``— the CLI: ``python -m gol_distributed_final_tpu_torch.analysis``

There is no ``jit-cache`` checker: it guards a compile cache keyed on a
Python-varying static turn argument and host calls inside a traced body,
and this package has neither (its kernels are CUDA built once per source,
with fixed turn-count instantiations behind ladders; its Python is never
traced).

The static layer's runtime twin is ``utils/locksan.py``: ``GOL_LOCKSAN=1``
swaps the instrumented classes' locks for order-recording wrappers that
abort on an observed inversion and watchdog long holds — what the AST
cannot resolve (dynamic dispatch, module-attribute objects), the
sanitizer observes live under ``scripts/check --locksan``.
"""

from __future__ import annotations

from .core import Checker, Finding, Report, run  # noqa: F401


def ast_checkers():
    """The per-file AST checkers, stable order."""
    from .hygiene import HygieneChecker
    from .lockorder import AtomicityChecker
    from .locks import LockDisciplineChecker
    from .skew import SkewSafetyChecker

    return [
        SkewSafetyChecker(),
        LockDisciplineChecker(),
        AtomicityChecker(),
        HygieneChecker(),
    ]


def concurrency_checkers():
    """The repo-level lock-composition checkers (lockorder.py): these
    are INVARIANT checkers like the AST set — ``--no-lint`` keeps them —
    but they need the whole tree (the acquisition graph spans modules),
    so they run through ``check_tree``."""
    from .lockorder import concurrency_repo_checkers

    return concurrency_repo_checkers()


def repo_checkers():
    """The repo-level checkers (README name-drift lints)."""
    from .lints import readme_checkers

    return readme_checkers()


def all_checkers():
    return ast_checkers() + concurrency_checkers() + repo_checkers()
