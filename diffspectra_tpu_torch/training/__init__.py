"""Training: the graph loss, the optimizer chain, the train state and step."""
