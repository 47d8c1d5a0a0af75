"""Deterministic test instrumentation for the PyTorch port.

:mod:`repro_torch.testing.faults` is the fault-injection harness behind the
broker durability tests (tests/test_torch_recovery.py): seeded fake
clocks, scripted/flaky delivery transports, journal crash/corruption
helpers, and bit-exact broker state capture.
"""
from .faults import (
    CapturingJournal,
    FakeClock,
    ScriptedTransport,
    assert_state_equal,
    broker_state,
    corrupt_tail,
    crash_at_record,
    tear_tail,
    tiny_caps,
)

__all__ = [
    "CapturingJournal",
    "FakeClock",
    "ScriptedTransport",
    "assert_state_equal",
    "broker_state",
    "corrupt_tail",
    "crash_at_record",
    "tear_tail",
    "tiny_caps",
]
