"""Trips single-engine three times: a re-derived threshold, a shadow def
and the shadow's reversed expression."""


def peel_once(eps, rho, degs):
    thresh = 2.0 * (1.0 + eps) * rho  # re-typed threshold (finding)
    return degs < thresh


def removal_threshold(eps, rho):  # shadow of the engine's one site (finding)
    return (1 + eps) * 2 * rho  # reversed operand order (finding)
