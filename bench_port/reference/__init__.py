"""The plain reference of each entry, in float64 (and, as the control, in
TF32): PyTorch and NumPy only, built from the configuration's arguments and
the benchmark's own inputs. It imports nothing of the port or of the JAX
package and reads no table, plan or output that the port made."""
