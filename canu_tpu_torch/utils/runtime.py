"""Process runtime services (AS_global runtime equivalents).

The port's counterpart of canu_tpu.utils.runtime's invocation audit and
crash catcher: the reference initializes every binary through
AS_configure, with a crash catcher printing a stack trace on fatal
signals (Canu src/AS_UTL/AS_UTL_stackTrace.C) and a per-invocation audit
log `canu-logs/<time>_<host>_<pid>_<tool>` recording argv
(Canu src/AS_global.C:59-160).

faulthandler dumps all-thread tracebacks on SIGSEGV/SIGFPE/SIGABRT/SIGBUS
into the same canu-logs directory; the audit file carries argv, the
package and torch versions and the torch device inventory.  Nothing here
imports jax.
"""

from __future__ import annotations

import os
import socket
import sys
import time


def _torch_devices() -> list[str]:
    import torch

    devs = ["cpu"]
    for i in range(torch.cuda.device_count()):
        devs.append(f"cuda:{i} {torch.cuda.get_device_name(i)}")
    return devs


def audit_invocation(log_dir: str, tool: str = "canu_tpu") -> str:
    """Write the per-invocation audit record; returns its path."""
    os.makedirs(log_dir, exist_ok=True)
    name = f"{int(time.time())}_{socket.gethostname()}_{os.getpid()}_{tool}"
    path = os.path.join(log_dir, name)
    lines = [
        f"tool: {tool}",
        f"time: {time.strftime('%Y-%m-%dT%H:%M:%S')}",
        f"host: {socket.gethostname()}",
        f"pid:  {os.getpid()}",
        f"cwd:  {os.getcwd()}",
        f"argv: {' '.join(sys.argv)}",
        f"python: {sys.version.split()[0]}",
    ]
    try:
        import torch

        lines.append(f"torch: {torch.__version__}")
        lines.append(f"devices: {_torch_devices()}")
    except Exception as e:  # device probing must never kill the tool
        lines.append(f"torch: unavailable ({e})")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


_crash_log_fh = None  # keep the fd alive for faulthandler


def install_crash_catcher(log_dir: str) -> str:
    """Register fatal-signal tracebacks into canu-logs (stack trace role).

    Returns the crash-log path.  Idempotent per process.
    """
    global _crash_log_fh
    import faulthandler

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"{int(time.time())}_{socket.gethostname()}_{os.getpid()}_crash"
    )
    if _crash_log_fh is None:
        _crash_log_fh = open(path, "w")
        faulthandler.enable(file=_crash_log_fh, all_threads=True)
        import signal

        # SIGSEGV/SIGFPE/SIGABRT/SIGBUS are covered by enable(); register
        # USR1 for on-demand dumps (like the reference's sigaction set)
        try:
            faulthandler.register(signal.SIGUSR1, file=_crash_log_fh, all_threads=True)
        except (AttributeError, ValueError, OSError, RuntimeError):
            pass
    return path


def rusage() -> dict:
    """CPU seconds and peak RSS of this process (timeAndSize equivalent)."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"utime_s": ru.ru_utime, "stime_s": ru.ru_stime, "max_rss_mb": ru.ru_maxrss / 1024.0}
