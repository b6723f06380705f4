from .quantity import Quantity, parse_quantity
