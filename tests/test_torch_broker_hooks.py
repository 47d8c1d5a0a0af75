"""repro_torch's Broker against repro's with a custom bank matcher and with
host round trips (CPU, exact); the cases are ``test_torch_broker_options.py``'s.
"""
import pytest

pytest.importorskip("torch")

from test_torch_broker_options import check_option  # noqa: E402


@pytest.mark.parametrize("case", ["matcher", "round_trip"])
def test_option_equals_reference(case):
    check_option(case)
