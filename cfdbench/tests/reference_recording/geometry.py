"""The frozen `geometry`, with `channel_case_geometry` recording its
keyword arguments."""

from ...reference import geometry as _frozen

calls: list = []


def channel_case_geometry(shape_name, **kwargs):
    calls.append(kwargs)
    return _frozen.channel_case_geometry(shape_name, **kwargs)
