"""Reset the process-wide observability singletons (registry, tracer,
flight ring, timeline sampler, journal, profiler, tenant ledger,
critical-path tracker, and the port's device accumulators) of the JAX
package and the PyTorch port, as the JAX package's own obs tests reset
theirs: every obs test leaves the process as it found it.

``Registry.reset`` zeroes a series but keeps it, so a site another test
file's run published stays in the kernel gauges at 0.0; those families are
written only through a fresh ``labels(site)`` (``obs/perf.refresh_metrics``)
and are emptied here."""

import importlib

# Derived per-site gauges: no module holds one of their children.
_KERNEL_GAUGES = ("gol_kernel_achieved_flops", "gol_kernel_achieved_bytes_per_s",
                  "gol_kernel_bound")


def reset_obs(*roots: str) -> None:
    for root in roots:
        obs = importlib.import_module(f"{root}.obs")
        mods = {
            name: importlib.import_module(f"{root}.obs.{name}")
            for name in ("metrics", "tracing", "flight", "timeline", "journal",
                         "profiler", "accounting", "critical", "device")
        }
        del obs
        mods["timeline"].disable()
        mods["journal"].disable()
        mods["profiler"].disable()
        mods["metrics"].enable(False)
        mods["metrics"].registry().reset()
        for fam in mods["metrics"].registry().families():
            if fam.name in _KERNEL_GAUGES:
                fam.children.clear()
        mods["tracing"].enable(False)
        mods["tracing"].tracer().reset()
        mods["flight"].enable(False)
        mods["flight"].recorder().reset()
        mods["accounting"].ledger().reset()
        mods["critical"].tracker().reset()
        mods["device"].reset_dispatch()
        mods["device"].reset_hbm()


def reset_both() -> None:
    reset_obs("gol_distributed_final_tpu", "gol_distributed_final_tpu_torch")
