"""The ADM UNet and its parameter conversion."""
