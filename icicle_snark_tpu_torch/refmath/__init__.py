"""Host-side (pure Python) BN254 math: the framework's reference oracle.

Plays the role of the reference's CPU backend: slow but trustworthy
implementations used for verification, trusted setup, and as the
differential-test oracle for the device kernels (SURVEY.md section 4).
"""

from . import field, tower, curve, pairing  # noqa: F401
