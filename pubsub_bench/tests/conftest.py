"""Every reader of a program span turns the program's spans on when it is
imported (``harness/program_spans.py``); a test that imports one leaves
them on for the rest of its worker unless they are turned off again."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def spans_off_after_each_test():
    from go_libp2p_pubsub_torch.utils import trace

    before = trace.recorder()
    yield
    trace.set_recorder(before)
