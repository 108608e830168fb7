from repro_torch.roofline.analysis import (HW, hw_for, roofline_report,
                                           roofline_terms, wire_bytes)

__all__ = ["HW", "hw_for", "roofline_report", "roofline_terms",
           "wire_bytes"]
