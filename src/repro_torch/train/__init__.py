"""Train state and step builders over the port's LM (``state``,
``train_step``)."""
