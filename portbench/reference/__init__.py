"""The plain float32 reference of the port's benchmark (``model.py``)."""
