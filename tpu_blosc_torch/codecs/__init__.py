"""Codec implementations and the open registry (≙ tpu_blosc/codecs/__init__.py)."""

from .registry import CodecProtocol, get_codec, list_codecs, register_codec

__all__ = ["CodecProtocol", "get_codec", "list_codecs", "register_codec"]
