"""Host core of the port: bits, letters, weights, trees, canonical codes.

Copies of the JAX package's :mod:`tpuhuff.core` modules that the port
needs, laid out under the same names, with the same arithmetic and bytes.
"""
