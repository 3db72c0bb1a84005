"""The control-plane core the simulated cloud shares with a manager
(``protocol``): the port's copy of part of the reference's ``manager``
package."""
