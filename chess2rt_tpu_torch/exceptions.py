"""Framework exceptions, mirroring the reference's hierarchy (rt/exception.d:5-69,
imageio/exception.d)."""

from __future__ import annotations


class RTException(Exception):
    """Base for all framework errors."""


class NotImplementedException(RTException):
    pass


class SceneNotFoundException(RTException):
    def __init__(self, msg: str = "Scene file not found!"):
        super().__init__(msg)


class InvalidSceneException(RTException):
    pass


class EntityWithDuplicateName(RTException):
    pass


class PropertyNotSpecified(RTException):
    pass


class ImageIOException(RTException):
    pass


class UnknownImageTypeException(ImageIOException):
    pass
