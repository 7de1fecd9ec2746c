# Copy of src/repro/core/__init__.py: the PyTorch port keeps its own copies and imports
# nothing of the JAX package.
# The paper's primary contribution — implement the SYSTEM here
# (scheduler, optimizer, data path, serving loop, etc.) in the
# host framework. Add sibling subpackages for substrates.
