from repro_torch.roofline.analysis import HW, hw_for, roofline_terms

__all__ = ["HW", "hw_for", "roofline_terms"]
