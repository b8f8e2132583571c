"""Reset the process-wide observability singletons (registry, tracer,
flight ring, timeline sampler, journal, profiler, tenant ledger,
critical-path tracker, and the port's device accumulators) of the JAX
package and the PyTorch port, as the JAX package's own obs tests reset
theirs: every obs test leaves the process as it found it."""

import importlib


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
