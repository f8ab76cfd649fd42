"""Deep goldens that start from a doctored state, replayed through the
port's facade on the CPU:
amidar_deep_iv and space_invaders_deep_iv.
Every digest, the score and the lives equal the golden's. The eight such
goldens are spread over four files so that test workers share them."""

import pytest

from tests.test_torch_facade import replay_deep_golden
from tests.test_torch_codecs import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["amidar_deep_iv",
                                  "space_invaders_deep_iv"])
def test_deep_golden_reproduces_on_the_port(name):
    replay_deep_golden(name)
