"""Rendering: ANSI string boards + optional pygame human/rgb_array output."""

from .string_renderer import board_to_string

__all__ = ["board_to_string"]
