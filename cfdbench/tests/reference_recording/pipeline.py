"""The frozen `pipeline`, with `make_predictor` recording its keyword
arguments."""

from ...reference import pipeline as _frozen

FAMILIES = _frozen.FAMILIES
SurrogateBundle = _frozen.SurrogateBundle
calls: list = []


def make_predictor(bundle, **kwargs):
    calls.append(kwargs)
    return _frozen.make_predictor(bundle, **kwargs)
