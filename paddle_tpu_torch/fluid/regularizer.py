"""``paddle.fluid.regularizer``: L1Decay / L2Decay and their
``*Regularizer`` names."""

from ..regularizer import L1Decay, L2Decay  # noqa: F401

L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay
