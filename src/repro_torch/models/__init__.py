"""The port's models: the dense and MoE families with GQA or MLA attention
(``model.Model``)."""
