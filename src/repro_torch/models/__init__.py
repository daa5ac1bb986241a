"""Dense transformer model: parameter trees, layers, attention, blocks."""
