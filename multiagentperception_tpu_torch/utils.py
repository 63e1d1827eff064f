"""Host-side helpers of the training loop (the port's own copies of
``host_rss_gb`` and ``reexec_self`` in multiagentperception_tpu/utils/__init__.py:84-122).

``training.rss_limit_gb`` turns a host-memory leak that would end a long
run in an out-of-memory kill into a planned restart: the trainer
checkpoints ``latest``, and ``reexec_self`` replaces the process with a
fresh image of the same command line, which resumes from that checkpoint
(``MAP_REEXEC_RESUME``) in the same run directory (``MAP_REEXEC_LOGDIR`` /
``MAP_REEXEC_RUN_IDX``, exported by the train CLI at each run's start).
"""

from __future__ import annotations

import gc
import os
import sys


def host_rss_gb() -> float:
    """This process's resident set size in GiB (``/proc/self/status``
    VmRSS; 0.0 where /proc is unavailable). Cheap enough for every
    iteration (~µs)."""
    try:
        with open("/proc/self/status") as fp:
            for line in fp:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / (1024.0 * 1024.0)
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def reexec_self(resume_path: str) -> None:
    """Replace this process with a fresh image of the same command line,
    which resumes training from ``resume_path`` (``MAP_REEXEC_RESUME``).
    Never returns. The command line is the interpreter's own
    (``sys.orig_argv``), so ``python -m multiagentperception_tpu_torch.train``
    comes back as a module run."""
    os.environ["MAP_REEXEC_RESUME"] = str(resume_path)
    # execv skips interpreter shutdown: release what the collector can first
    gc.collect()
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [sys.executable] + sys.orig_argv[1:])
