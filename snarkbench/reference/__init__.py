"""The benchmark's plain reference: BN254 field, curve and pairing
(frozen copies of the port's host math), the verification key worked out
from the circuit and the ceremony's seed, and the checks of each answer."""
