"""Single source of truth for the process exit-code contract.

The supervision stack communicates failure *kind* through process return
codes, and every layer (elastic agent, launcher supervisor, MPMD driver,
chaos harness, test assertions) dispatches on the same four values:

========================  =====  ====================================================
name                      value  meaning
========================  =====  ====================================================
``PREEMPTION_EXIT_CODE``  114    voluntary exit after a checkpoint-and-resume
                                 preemption; does NOT count against restart budgets
``STALL_EXIT_CODE``       117    the watchdog declared the process wedged; counts
                                 as a failure for elastic restart accounting
``INTEGRITY_EXIT_CODE``   118    the sentinel detected silent data corruption; the
                                 relaunch must resume from the last good checkpoint
``KILL_EXIT_CODE``        13     a chaos failpoint killed the process on purpose;
                                 distinct from every organic rc so tests can tell
                                 "chaos killed it" apart from a real crash
========================  =====  ====================================================

Counterpart of ``deepspeed_tpu/exit_codes.py``: the same four values,
so a supervisor of either package reads the other's return codes.
"""

from __future__ import annotations

#: rc for a voluntary checkpoint-then-exit preemption (resumable).
PREEMPTION_EXIT_CODE = 114

#: rc the stall watchdog uses when it declares the process wedged.
STALL_EXIT_CODE = 117

#: rc the SDC sentinel uses when training state fails an integrity check.
INTEGRITY_EXIT_CODE = 118

#: rc chaos-injected kills use so tests can distinguish them from crashes.
KILL_EXIT_CODE = 13

__all__ = [
    "PREEMPTION_EXIT_CODE",
    "STALL_EXIT_CODE",
    "INTEGRITY_EXIT_CODE",
    "KILL_EXIT_CODE",
]
