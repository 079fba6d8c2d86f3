"""Utility namespace (port of ``paddle_tpu/utils``): process lifetime
hardening for the server subprocesses."""
from .procutil import pdeathsig_preexec, start_ppid_watchdog  # noqa: F401

__all__ = ["pdeathsig_preexec", "start_ppid_watchdog"]
