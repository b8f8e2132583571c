"""The broker of a run, in a process of its own.

    python broker_child.py [--fault NAME] -- <broker arguments>

runs ``gol_distributed_final_tpu_torch.rpc.broker.main`` with the broker
arguments, as ``python -m gol_distributed_final_tpu_torch.rpc.broker``
would, and takes one command a line on standard input, each answered by a
line ``BENCH-ACK <command>`` on standard output:

* ``trace-start``: start ``torch.profiler`` over the card (and the host's
  CUDA calls);
* ``trace-stop PATH``: stop it, and write the device records and launch
  calls to PATH as JSON (``kineto`` times, ns since the epoch);
* ``stats PATH``: write the card's name, this process's peak of
  allocated device memory and the forbidden modules it holds
  (``harness/nojax.py``) to PATH;
* ``exit`` (or the end of input): end the process at once.

``--fault`` plants one fault in the broker's replies (``harness/faults.py``):
only the benchmark's tests and its control runs pass it.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import threading

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _write(path: str, data) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def _records(prof) -> dict:
    """Every device record (kernels, copies, sets) and every host call that
    launches one, from the profiler's results."""
    from torch.autograd import DeviceType

    names, device, calls = {}, [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            key = names.setdefault(ev.name(), len(names))
            device.append([key, ev.start_ns(), ev.start_ns() + ev.duration_ns()])
        elif ev.name().startswith(("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                                   "cuLaunchKernel")):
            calls.append(ev.start_ns())
    return {"names": list(names), "device": device, "launch_calls": calls}


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities)


def _sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _control(stdin, stdout) -> None:
    prof = None
    for line in stdin:
        cmd, _, arg = line.strip().partition(" ")
        if cmd == "trace-start":
            _sync()
            prof = _profile()
            prof.start()
        elif cmd == "trace-stop":
            _sync()
            prof.stop()
            records = _records(prof)
            # records that a trace loses can come in the next one: an empty
            # window takes them, and the reader keeps what lies in its window
            late = _profile()
            late.start()
            _sync()
            late.stop()
            extra = _records(late)
            records["device"] += [[len(records["names"]) + k, start, end]
                                  for k, start, end in extra["device"]]
            records["names"] += extra["names"]
            _write(arg, records)
            prof = None
        elif cmd == "stats":
            import torch

            from benchmark.harness import nojax

            cuda = torch.cuda.is_available()
            _write(arg, {
                "kind": torch.cuda.get_device_name() if cuda else "cpu",
                "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0,
                "forbidden": nojax.loaded(),
            })
        elif cmd == "exit":
            break
        stdout.write(f"BENCH-ACK {cmd}\n")
        stdout.flush()
    os._exit(0)


def main(argv) -> None:
    fault = None
    if argv[:1] == ["--fault"]:
        fault, argv = argv[1], argv[2:]
    if argv[:1] == ["--"]:
        argv = argv[1:]
    sys.path.insert(0, str(ROOT))
    from gol_distributed_final_tpu_torch.rpc import broker

    if fault is not None:
        from benchmark.harness import faults

        faults.install(fault, broker.BrokerService)
    threading.Thread(target=_control, args=(sys.stdin, sys.stdout), daemon=True).start()
    broker.main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
