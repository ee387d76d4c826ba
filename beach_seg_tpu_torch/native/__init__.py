"""The native host-I/O library (GeoTIFF codec, polygon fill, contours):
C++ sources copied from the JAX package, built by ``build`` on first use."""
