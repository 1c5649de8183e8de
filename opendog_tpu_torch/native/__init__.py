"""The C++ firmware simulators (copies of the JAX package's ``native/``)
and their build: :mod:`.build`."""
