"""Training state and step functions of the port."""
