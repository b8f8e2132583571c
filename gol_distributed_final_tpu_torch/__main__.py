"""Controller process entry point — the main.go equivalent.

Flags mirror the reference (main.go:17-46): -t threads, -w width, -h
height, -turns, -noVis, -server (a broker's host:port, else the engine
runs in process), plus -rule (a B.../S... rulestring), -resume (continue
from a checkpoint, engine/checkpoint.py) and -device (where an in-process
session computes: default cuda; ``-device cpu`` runs on the CPU; with
-server the broker's own -device decides), and the observability flags
-metrics, -report, -trace, -trace-device, -timeline and -profile (obs/),
with the JAX package's meanings and defaults. ``-h`` is board height as in
the reference, so argparse's auto-help is disabled; use --help.

Without -noVis the visualiser loop consumes the event stream (main.go:57,
viz/loop.py): an in-process engine feeds it per-cell flips, which it draws
into the SDL window where the host has libSDL2 and a display, else into
the headless window, and the window's keys p/s/q/k drive the session.
With -noVis the run drains the event stream, and with a TTY keypresses
s/q/k/p are read raw from stdin and forwarded like the SDL keymap
(sdl/loop.go:16-28). Either way every event with a non-empty string is
printed as ``Completed Turns <n> <event>`` (sdl/loop.go:44-47;
main.go:59-67).
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading


def _stdin_keys(keypresses: "queue.Queue", done: threading.Event) -> None:
    """Forward raw single-key presses (s/q/k/p) from a TTY.

    The terminal mode is saved/restored by the caller, not here: this
    daemon thread dies blocked in read(1) at process exit, so its finally
    would never run."""
    while not done.is_set():
        ch = sys.stdin.read(1)
        if ch in ("s", "q", "k", "p"):
            keypresses.put(ch)


def start_tty_keys(keypresses: "queue.Queue"):
    """Put the terminal in cbreak mode and forward s/q/k/p keys; returns
    a restore() callable (a no-op off-tty)."""
    if not sys.stdin.isatty():
        return lambda: None
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    done = threading.Event()
    threading.Thread(
        target=_stdin_keys, args=(keypresses, done), daemon=True
    ).start()

    def restore():
        done.set()
        termios.tcsetattr(fd, termios.TCSADRAIN, old)

    return restore


def drain_events(events: "queue.Queue") -> None:
    """Headless consumer (main.go:59-67's -noVis drain): print every event
    with a non-empty string as ``Completed Turns <n> <event>`` until the
    CLOSED sentinel."""
    from .engine.controller import iter_events

    for ev in iter_events(events):
        text = str(ev)
        if text:
            print(f"Completed Turns {ev.get_completed_turns()} {text}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gol_distributed_final_tpu_torch", add_help=False
    )
    parser.add_argument("--help", action="help")
    parser.add_argument("-t", type=int, default=8, help="threads (kept for the reference's CLI)")
    parser.add_argument("-w", type=int, default=512, help="board width")
    parser.add_argument("-h", type=int, default=512, help="board height")
    parser.add_argument("-turns", type=int, default=10000000000)
    parser.add_argument("-noVis", action="store_true", default=False)
    parser.add_argument(
        "-server", default="", help="broker address (empty: in-process engine)"
    )
    parser.add_argument(
        "-resume", default=None, metavar="CKPT",
        help="continue from an engine/checkpoint.py .npz instead of "
             "images/<W>x<H>.pgm at turn 0; with -server the checkpoint's "
             "board, turn, and rule are shipped to the remote broker",
    )
    parser.add_argument(
        "-rule", default=None, metavar="B.../S...",
        help="life-like rulestring (default Conway B3/S23)",
    )
    parser.add_argument(
        "-device", default=None,
        help="where an in-process session's board lives: cuda (default; "
             "fails without a card) or cpu; not with -server",
    )
    parser.add_argument(
        "-trace", action="store_true", default=False,
        help="enable the span tracer + flight recorder (obs/tracing.py): "
             "the session becomes one cross-process trace (controller, "
             "broker, workers share a trace_id via Request.trace_ctx) and "
             "a Perfetto-loadable Chrome trace lands in "
             "out/trace_<W>x<H>x<Turns>.json at session end",
    )
    parser.add_argument(
        "-trace-device", dest="trace_device", nargs="?", const="out/trace_device",
        default=None, metavar="DIR",
        help="wrap the session in a torch.profiler trace of the host and "
             "the card written to DIR (default out/trace_device); span "
             "names ride along as record_function ranges so host and "
             "device timelines line up",
    )
    parser.add_argument(
        "-metrics", action="store_true", default=False,
        help="enable the metrics registry (obs/): engine, controller, "
             "RPC-client and kernel timings accumulate in-process",
    )
    parser.add_argument(
        "-report", action="store_true", default=False,
        help="write out/report_<W>x<H>x<Turns>.json (metrics + device "
             "inventory) at FinalTurnComplete; implies -metrics",
    )
    parser.add_argument(
        "-timeline", nargs="?", const=1.0, default=None, type=float,
        metavar="SECS",
        help="enable the in-process metric timeline + SLO rulebook "
             "(obs/timeline.py, obs/slo.py) at this sampling cadence "
             "(default 1 s): rates/p99s and alert states land in the run "
             "report, and counter tracks join the -trace Chrome export; "
             "implies -metrics",
    )
    parser.add_argument(
        "-profile", nargs="?", const=10.0, default=None, type=float,
        metavar="MS",
        help="enable the continuous sampling profiler (obs/profiler.py) "
             "at this cadence (default 10 ms, adaptive backoff): the run "
             "report embeds the hot-frame summary and collapsed-stack + "
             "speedscope artifacts land in out/ at session end; implies "
             "-metrics",
    )
    args = parser.parse_args(argv)
    if args.metrics or args.report:
        # before any instrumented path runs, so the report sees the whole
        # session
        from .obs import metrics

        metrics.enable()
    if args.timeline is not None:
        if args.timeline <= 0:
            parser.error(f"-timeline SECS must be > 0, got {args.timeline}")
        from .obs import timeline

        timeline.enable(period=args.timeline)  # implies metrics.enable()
    if args.trace:
        # the controller role labels this process's track in the export
        from .obs import flight, tracing

        tracing.enable()
        tracing.set_process_name("controller")
        flight.enable()
    if args.profile is not None:
        if args.profile <= 0:
            parser.error(f"-profile MS must be > 0, got {args.profile}")
        from .obs import profiler as _profiler

        _profiler.enable(period_ms=args.profile, tag="controller")  # implies metrics
    if args.rule and args.resume:
        parser.error("-rule conflicts with -resume (the checkpoint's rule wins)")
    rule = None
    if args.rule:
        # validate BEFORE any thread starts
        from .models import LifeRule

        try:
            rule = LifeRule.from_rulestring(args.rule)
        except ValueError as e:
            parser.error(str(e))
    resume = None
    if args.resume:
        # verified now, with a typed refusal, and passed on so the file is
        # read and hashed once
        from .engine.checkpoint import CheckpointError, load_verified_checkpoint

        try:
            resume = load_verified_checkpoint(args.resume)
        except CheckpointError as e:
            parser.error(f"-resume {args.resume}: {e}")
    device = broker = None
    if args.server:
        if args.device is not None:
            parser.error("-device is the broker's with -server")
    else:
        from .device import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            parser.error(str(e))

    from . import Params, run

    params = Params(
        turns=args.turns, threads=args.t, image_width=args.w, image_height=args.h
    )
    if args.server:
        from .rpc.client import RemoteBroker

        print("Server: ", args.server)
        broker = RemoteBroker(args.server)
    events: "queue.Queue" = queue.Queue()
    keypresses: "queue.Queue" = queue.Queue()
    if args.noVis:
        # headless drain (main.go:59-67)
        restore_tty = start_tty_keys(keypresses)
        consumer = threading.Thread(target=drain_events, args=(events,))
    else:
        # the visualiser loop (main.go:57, sdl.Run), whose window's keys
        # are the keypresses
        from .viz import run as viz_run

        restore_tty = lambda: None  # noqa: E731
        consumer = threading.Thread(target=viz_run, args=(params, events, keypresses))
    consumer.start()
    try:
        import contextlib

        trace_ctx = contextlib.nullcontext()
        if args.trace_device:
            # the profiler's trace, with the span names as ranges
            from .obs.tracing import device_trace

            trace_ctx = device_trace(args.trace_device)
        with trace_ctx:
            # the in-process engine can feed the visualiser per-cell flips;
            # the remote path (like the reference's distributed mode) cannot
            run(params, events, keypresses, broker=broker, rule=rule, device=device,
                resume_from=resume, emit_flips=not args.noVis and broker is None,
                report=args.report, trace_export=args.trace)
    except BaseException as exc:
        if args.profile is not None:
            from .obs import profiler as _profiler

            # the profile of the session that died, on disk
            _profiler.flush_on_crash(exc)
        raise
    finally:
        if args.profile is not None:
            from .obs import profiler as _profiler

            _profiler.shutdown()  # run-end artifacts + gc unhook
        consumer.join()
        restore_tty()
        if broker is not None:
            broker.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
