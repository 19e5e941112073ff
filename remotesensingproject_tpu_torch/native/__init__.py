"""Native (C++) host components of the port.

``loader.cpp``, a multi-threaded image-stack decoder (TIFF with LZW, PNG
through libpng, JPEG through libjpeg, PGM/PPM), the port's copy of the JAX
package's, built with g++ at first use and bound with ctypes
(``loader.py``).  ``utils.io.read_imgs_from_folder`` uses it by default
and falls back to PIL, with a RuntimeWarning, where it cannot.
"""
