"""Plain PyTorch and NumPy reference of a served HOLMES score.

Imports neither JAX, the JAX package nor the port: the ResNeXt forward,
the random forest and the logistic regression are frozen copies of the
maths the port serves, written out here so that later changes to the
program cannot move the yardstick."""
