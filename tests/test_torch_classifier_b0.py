"""The B0 image classifier against the JAX package's, at 24 px and B 16
with random running statistics, by the tolerances of
``tests/test_torch_classifier.py``: its eval logits, its eval step's loss
and pred, and its train step's loss and updated running statistics,
against the JAX classifier's forward in one compiled call. JAX's B0
train step is not compiled here: under the suite's workers its compile
alone takes most of a minute. The B0 encoder's gradients and updates
are held to JAX's step in ``tests/test_torch_b0_card.py``; the head's and
the classifier step's in ``tests/test_torch_classifier.py`` (the ViT,
transformer and CNN cases, the CNN with its running statistics)."""

from test_torch_classifier import (
    _jax_forward_run, check_forward_step, check_logits,
)


def test_b0_logits_match_jax():
    check_logits("image-b0", _jax_forward_run)


def test_b0_train_step_matches_jax():
    check_forward_step("image-b0")
