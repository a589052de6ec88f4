"""The error a reader raises where cv2.imread would return None, shared by
utils/image_io.py and the format modules it calls."""


class DecodeError(ValueError):
    """The file is not an image this package decodes (cv2.imread gives
    None)."""
