"""The port's models: the dense GQA family (``model.Model``)."""
