"""ctypes binding of the native C++ host codec (see backend.py)."""
