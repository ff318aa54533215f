"""The ARMT Llama model: layers, attention, the attn block, the fused
grouped cell and the model/serving functions."""
