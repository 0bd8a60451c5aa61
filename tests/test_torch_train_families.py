"""The port's train step against ``repro``'s for the hybrid, vlm and audio
families' reduced configs (with a random ``cond`` and the vlm's cross
gates drawn nonzero), with the bounds ``tests/_torch_train.py`` states."""
import pytest

import _torch_train as T
from _torch_train import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", ["hybrid", "vlm", "audio"])
def test_step_matches_reference(family):
    T.check_step(T.FAMILY_ARCHS[family])
