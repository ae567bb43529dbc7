"""The benchmark's circuits: frozen copies of the port's host builders
and, per configuration, the module that makes its inputs from a seed."""
